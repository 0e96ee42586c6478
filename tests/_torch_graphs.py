"""Stand-ins for the card's CUDA graphs in the port's CPU tests of
``openvoice_tpu_torch/runtime/graphs.py`` (tests/test_torch_graphs*.py).

There is no card here, so capture and replay go through a stand-in
(`fake_graphs`): a "capture" runs the body once for its outputs and then
puts back every tensor of the state the body was bound to (a real capture
executes nothing, so a train step's capture must not step), checking that no
Python-side value of that state moved; a "replay" runs the body again on the
static buffers and writes the captured outputs in place, as a replay writes
the graph's output buffers.  Everything around them (staging, keys, the
replay's consumers, launch tallies) is the port's own code."""

import contextlib

import pytest
import torch

from openvoice_tpu_torch.runtime import graphs as G
from openvoice_tpu_torch.training import train as TT


class _Stream:
    def wait_event(self, event):
        pass

    def wait_stream(self, stream):
        pass


class _Event:
    def record(self, stream=None):
        pass


class _Graph:
    """Stands in for a captured CUDA graph: `replay` runs the captured body
    on its static buffers and writes the captured outputs in place."""

    def __init__(self):
        self.body = self.static = self.outputs = None
        self.replayed = 0

    def replay(self):
        new = self.body(**self.static)
        for out, value in zip(G._tensors(self.outputs), G._tensors(new)):
            out.copy_(value)
        self.replayed += 1


def _train_states(args) -> list:
    """The train states among a body's bound arguments, each alone (a GAN
    state as its two)."""
    out = []
    for a in args:
        if isinstance(a, TT.GanTrainState):
            out += [a.gen, a.disc]
        elif isinstance(a, TT.TrainState):
            out.append(a)
    return out


def _held_tensors(args) -> list[torch.Tensor]:
    """Every tensor a body's bound arguments hold: the modules' parameters
    and buffers, and of each train state its model's and its optimizer's."""
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out += list(a.parameters()) + list(a.buffers())
    for ts in _train_states(args):
        out += list(ts.model.parameters()) + list(ts.model.buffers())
        out += [v for st in ts.opt.state.values() for v in st.values() if torch.is_tensor(v)]
    return out


def _python_side(args) -> list:
    """What a capture must leave as it is: each train state's step count,
    which parameters hold a ``.grad``, the optimizer's states and rates."""
    return [(ts.step, [p.grad is None for p in ts.model.parameters()], len(ts.opt.state),
             [float(g["lr"]) for g in ts.opt.param_groups]) for ts in _train_states(args)]


def _record(graph, body, static, stream, device):
    args = getattr(body, "args", ())
    held = _held_tensors(args)
    saved = [x.detach().clone() for x in held]
    before = _python_side(args)
    graph.body, graph.static = body, static
    graph.outputs = body(**static)
    with torch.no_grad():
        for x, value in zip(held, saved):
            x.copy_(value)
    assert _python_side(args) == before, "a capture moved a Python-side value of the state"
    return graph.outputs


def install_fake_graphs(mp) -> None:
    """Graph caches on the CPU capture and replay through `_Graph`
    (`mp`: a monkeypatch)."""
    mp.setattr(G, "_capturable", lambda device: True)
    mp.setattr(G, "_streams", lambda device: (_Stream(), _Stream()))
    mp.setattr(G, "_record", _record)
    mp.setattr(G, "_LAST", {})
    mp.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    mp.setattr(torch.cuda, "Event", _Event)
    mp.setattr(torch.cuda, "CUDAGraph", _Graph)


@pytest.fixture
def fake_graphs(monkeypatch):
    install_fake_graphs(monkeypatch)


@pytest.fixture
def no_cuda_graphs(monkeypatch):
    """Any capture or replay of a real CUDA graph raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was captured or replayed on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
