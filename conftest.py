"""Session-wide test settings that must be in place before any test module
or child process starts.

Several tests launch multi-process JAX worlds as child processes.  A child
inherits this process's environment and, left alone, keeps the package's
persistent compilation cache under the user's cache directory, where it is
shared with every other child and outlives the run.  JAX writes that cache
from process 0 only, under keys that differ per process, so process 0 of a
two-process world can load in milliseconds what process 1 must compile for
many seconds.  Process 0 then waits inside its first train step for its peer,
the per-step heartbeat behind that step times out, both workers report a lost
peer, and every relaunch repeats it.  Without the persistent cache both
processes compile the same programs on every launch and stay in step, so the
children run with the package's opt-out set.  The test process's own cache
(tests/conftest.py sets it through jax.config) is not affected, and a caller
who exports OPENVOICE_TPU_NO_COMPILE_CACHE= (empty) keeps the children's cache.
"""

import os

os.environ.setdefault("OPENVOICE_TPU_NO_COMPILE_CACHE", "1")
