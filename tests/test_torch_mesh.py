"""The port's mesh tier in one process against the JAX package's on its
8-device CPU mesh (tests/test_distributed.py, tests/test_serve.py:165-205),
at the JAX suite's TINY config: `required_halo`, the sequence-parallel
convert on a 2×4 mesh, the tensor-parallel generator and convert, the
parameter-sharding rules, data-parallel conversion and the mesh batcher.

Each result is held against the JAX function on its mesh and against the
port's one-device result at the JAX suite's bar (atol 2e-5, rtol 1e-4); the
batcher against the one-device batcher at 5e-5 (spectrogram requests) and
5e-4 (PCM requests).  The port's 2×4 mesh repeats the CPU device: each
position runs in its own thread, and the collectives are copies and sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvoice_tpu.config import V2_CONVERTER_CONFIG as JV2
from openvoice_tpu.models import synthesizer as JS
from openvoice_tpu.nn.hifigan import apply_generator as j_apply_generator
from openvoice_tpu.runtime import mesh as JM
from openvoice_tpu.runtime import sequence_parallel as JSP
from openvoice_tpu_torch.config import V2_CONVERTER_CONFIG as TV2
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.nn.hifigan import apply_generator
from openvoice_tpu_torch.runtime import sequence_parallel as TSP
from openvoice_tpu_torch.runtime.mesh import make_mesh, params_shardings, shard_params
from openvoice_tpu_torch.runtime.parallel import TensorParallel, data_parallel_convert
from openvoice_tpu_torch.serve.batcher import ConvertBatcher, ConvertRequest
from tests._torch_port import TINY_TAIL, jax_cfg, jax_params, t, torch_cfg, torch_model

# tests/test_distributed.py's TINY
TINY_D = dict(
    n_speakers=0, zero_g=True,
    spec_channels=65, filter_length=128, hop_length=32, win_length=128,
    inter_channels=32, hidden_channels=32,
    upsample_initial_channel=64, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    gin_channels=32, enc_q_layers=4, flow_n_flows=2, flow_wn_layers=2,
)
B, T = 2, 256
ATOL, RTOL = 2e-5, 1e-4
CPU8 = ["cpu"] * 8

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-virtual-device CPU backend")


@pytest.fixture(scope="module")
def setup():
    params = jax_params(TINY_D, seed=0)
    rng = np.random.default_rng(0)
    spec = np.abs(rng.standard_normal((B, T, TINY_D["spec_channels"]))).astype(np.float32)
    lens = np.asarray([T, T - 37], np.int32)
    g_src = rng.standard_normal((B, 1, TINY_D["gin_channels"])).astype(np.float32) * 0.2
    g_tgt = rng.standard_normal((B, 1, TINY_D["gin_channels"])).astype(np.float32) * 0.2
    noise = rng.standard_normal((B, T, TINY_D["inter_channels"])).astype(np.float32)
    model = torch_model(TINY_D, params)
    with torch.no_grad():
        ref, _ = TS.voice_conversion(model, t(spec), t(lens).long(), t(g_src), t(g_tgt), 0.3, t(noise))
    return params, model, (spec, lens, g_src, g_tgt, noise), ref.numpy()


def _jargs(inputs):
    return [jnp.asarray(a) for a in inputs]


def test_required_halo_matches_jax():
    assert TSP.required_halo(torch_cfg(TINY_D)) == JSP.required_halo(jax_cfg(TINY_D))
    assert TSP.required_halo(TV2) == JSP.required_halo(JV2)
    assert 96 < TSP.required_halo(TV2) < 160


def test_sequence_parallel_matches_jax_and_single_device(setup):
    params, model, inputs, ref = setup
    spec, lens, g_src, g_tgt, noise = _jargs(inputs)
    sp = jax.jit(lambda p, *a: JSP.voice_conversion_sp(p, jax_cfg(TINY_D), *a[:4], 0.3, a[4],
                                                       mesh=JM.make_mesh(8, data=2, model=4), axis="model"))
    theirs = sp(params, spec, lens, g_src, g_tgt, noise)
    mesh = make_mesh(8, data=2, model=4, devices=CPU8)
    ours = TSP.voice_conversion_sp(model, *(t(a) for a in inputs[:4]), 0.3, t(inputs[4]), mesh=mesh)
    assert ours.spec == (None, "model", None) and set(ours.shards) == set(mesh.local_coords())
    got = ours.gather().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(theirs), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frames, halo, match", [(64, 60, "halo"), (250, None, "not divisible")])
def test_sequence_parallel_rejects_short_or_uneven_shards(setup, frames, halo, match):
    _, model, (spec, lens, g_src, g_tgt, noise), _ = setup
    mesh = make_mesh(8, data=1, model=8, devices=CPU8)
    with pytest.raises(ValueError, match=match):
        TSP.voice_conversion_sp(model, t(spec[:, :frames]), t(lens), t(g_src), t(g_tgt), 0.3,
                                t(noise[:, :frames]), mesh=mesh, halo=halo)


def test_sharding_rules_split_what_jax_splits(setup):
    """The rules split the same tensors as the JAX package's on this mesh
    (JAX paths through the weight bridge's names), on axis 0 of the port's
    layouts, and `shard_params` holds 1/4 of each on every model position."""
    params, model, _, _ = setup
    mesh = make_mesh(8, data=2, model=4, devices=CPU8)
    ours = {k for k, v in params_shardings(model, mesh).items() if v}
    assert params_shardings(model, mesh)["dec.conv_pre.weight"] == ("model", None, None)
    assert params_shardings(model, mesh)["dec.ups.0.weight"] == ("model", None, None)
    jspecs = JM.params_shardings(params, JM.make_mesh(8, data=2, model=4))

    def port_name(path) -> str:
        """A JAX parameter path → the port's state_dict name."""
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path][:-1]  # less the leaf "w"
        if keys[0] == "flow":  # odd flow slots are the parameter-free flips
            keys = ["flow", "flows", str(2 * int(keys[2]))] + keys[3:]
        out: list[str] = []
        for k in keys:  # a WaveNet's "in" and "cond" are its in_layers and cond_layer
            inside_wn = bool(out) and out[-1] == "enc"
            out.append("enc" if k == "wn" else {"in": "in_layers", "cond": "cond_layer"}.get(k, k) if inside_wn else k)
        return ".".join(out) + ".weight"

    theirs = {port_name(p) for p, s in jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "spec")) if any(a is not None for a in s.spec)}
    assert ours == theirs
    sd = model.state_dict()
    for coord, local in shard_params(model, mesh).items():
        for name in ours:
            assert local[name].shape[0] * 4 == sd[name].shape[0]
            torch.testing.assert_close(local[name], sd[name].chunk(4)[coord[1]], rtol=0, atol=0)
        assert torch.equal(local["dec.conv_post.weight"], sd["dec.conv_post.weight"])


def test_sharding_keeps_undividable_axes_whole(setup):
    _, model, _, _ = setup
    mesh = make_mesh(3, data=1, model=3, devices=["cpu"] * 3)
    assert params_shardings(model, mesh)["dec.conv_pre.weight"] == ()  # 64 channels over 3


def test_tensor_parallel_generator_matches_jax_and_single_device(setup):
    params, model, (_, _, _, g_tgt, _), _ = setup
    z = np.random.default_rng(5).standard_normal((B, T, TINY_D["inter_channels"])).astype(np.float32)
    kw = dict(resblock_kind="1", resblock_dilation_sizes=TINY_D["resblock_dilation_sizes"],
              upsample_rates=TINY_D["upsample_rates"], upsample_kernel_sizes=TINY_D["upsample_kernel_sizes"])
    jmesh = JM.make_mesh(8, data=2, model=4)
    fwd = jax.jit(lambda p, zz, gg: j_apply_generator(p, zz, g=gg, **kw))
    theirs = fwd(JM.shard_params(params, jmesh)["dec"], jax.device_put(jnp.asarray(z), JM.batch_sharding(jmesh)),
                 jax.device_put(jnp.asarray(g_tgt), JM.batch_sharding(jmesh)))
    with torch.no_grad():
        single = apply_generator(model.dec, t(z), g=t(g_tgt)).numpy()
    tp = TensorParallel(model, torch_cfg(TINY_D), make_mesh(8, data=2, model=4, devices=CPU8))
    layer = tp.models[(1, 2)].dec.conv_pre
    assert tuple(layer.weight.shape) == (16, 32, 7)  # a quarter of the 64 output channels, at rest
    got = tp.generator(t(z), t(g_tgt)).gather().numpy()
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(theirs), atol=ATOL, rtol=RTOL)


def test_tensor_parallel_convert_matches_jax_and_single_device(setup):
    params, model, inputs, ref = setup
    jmesh = JM.make_mesh(8, data=2, model=4)
    bs = JM.batch_sharding(jmesh)
    jargs = [jax.device_put(a, bs) for a in _jargs(inputs)]
    theirs, _ = jax.jit(lambda p, s, l, gs, gt, n: JS.voice_conversion(p, jax_cfg(TINY_D), s, l, gs, gt, 0.3, n))(
        JM.shard_params(params, jmesh), *jargs)
    tp = TensorParallel(model.state_dict(), torch_cfg(TINY_D), make_mesh(8, data=2, model=4, devices=CPU8))
    spec, lens, g_src, g_tgt, noise = (t(a) for a in inputs)
    got = tp.convert(spec, lens.long(), g_src, g_tgt, 0.3, noise)
    assert got.spec == ("data", None, None) and got.shards[(1, 3)].shape[0] == 1
    got = got.gather().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(theirs), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fast", [False, True])
def test_data_parallel_convert_matches_single_device(fast):
    """Rows over a 4-position data axis, in both modes (the serving mode on
    the kernels' plain versions here); a row of length 0 comes out 0."""
    params = jax_params(TINY_TAIL, seed=3)
    model = torch_model(TINY_TAIL, params)
    rng = np.random.default_rng(4)
    n, frames = 8, 96
    spec = t(np.abs(rng.standard_normal((n, frames, TINY_TAIL["spec_channels"]))).astype(np.float32))
    lens = torch.tensor([96, 80, 0, 64, 96, 33, 90, 0])
    gs = t(rng.standard_normal((n, 1, TINY_TAIL["gin_channels"])).astype(np.float32) * 0.2)
    gt = t(rng.standard_normal((n, 1, TINY_TAIL["gin_channels"])).astype(np.float32) * 0.2)
    noise = t(rng.standard_normal((n, frames, TINY_TAIL["inter_channels"])).astype(np.float32))
    cache = TS.make_dec_cache(model) if fast else None
    with torch.no_grad():
        ref, _ = TS.voice_conversion(model, spec, lens, gs, gt, 0.3, noise, fast=fast, dec_cache=cache)
    mesh = make_mesh(4, data=4, model=1, devices=["cpu"] * 4)
    out = data_parallel_convert(model, mesh, spec, lens, gs, gt, 0.3, noise, fast=fast)
    assert [out.shards[(d, 0)].shape[0] for d in range(4)] == [2, 2, 2, 2]
    got = out.gather()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    assert torch.count_nonzero(got[lens == 0]) == 0


def _req(n_frames: int, seed: int, cfg) -> ConvertRequest:
    rng = np.random.default_rng(seed)
    return ConvertRequest(
        spec=np.abs(rng.standard_normal((n_frames, cfg.spec_channels))).astype(np.float32), n_frames=n_frames,
        g_src=rng.standard_normal(cfg.gin_channels).astype(np.float32),
        g_tgt=rng.standard_normal(cfg.gin_channels).astype(np.float32), tau=0.3, seed=seed)


@pytest.mark.parametrize("fast", [False, True])
def test_mesh_batcher_matches_single_device_batcher(fast):
    """tests/test_serve.py:165-205 for the port: a batcher over a 4×1 mesh
    splits each group's rows over the data axis (padded to a multiple of
    4); its results equal the one-device batcher's for the same requests,
    spectrogram requests within 5e-5 and PCM requests within 5e-4."""
    cfg = torch_cfg(TINY_TAIL)
    model = torch_model(TINY_TAIL, jax_params(TINY_TAIL, seed=0))
    single = ConvertBatcher(model, cfg, max_batch=4, max_wait_ms=10, fast=fast, device="cpu")
    mesh = make_mesh(4, data=4, model=1, devices=["cpu"] * 4)
    sharded = ConvertBatcher(model, cfg, max_batch=4, max_wait_ms=10, fast=fast, mesh=mesh)
    assert len(sharded._shards) == 4
    single.start()
    sharded.start()
    try:
        reqs = [(48, 3), (48, 4), (52, 5), (40, 6), (40, 7)]
        ones = [single.submit(_req(n, s, cfg)).result(timeout=120) for n, s in reqs]
        futs = [sharded.submit(_req(n, s, cfg)) for n, s in reqs]
        for one, fut in zip(ones, futs):
            got = fut.result(timeout=120)
            assert got.shape == one.shape
            np.testing.assert_allclose(got, one, atol=5e-5)
        rng = np.random.default_rng(21)
        wave = (rng.standard_normal(48 * cfg.hop_length) * 0.1).astype(np.float32)
        g_s = rng.standard_normal(cfg.gin_channels).astype(np.float32)
        g_t = rng.standard_normal(cfg.gin_channels).astype(np.float32)
        one = single.submit(ConvertRequest(audio=wave, g_src=g_s, g_tgt=g_t, tau=0.3, seed=9)).result(timeout=120)
        two = sharded.submit(ConvertRequest(audio=wave, g_src=g_s, g_tgt=g_t, tau=0.3, seed=9)).result(timeout=120)
        np.testing.assert_allclose(two, one, atol=5e-4)
    finally:
        single.stop()
        sharded.stop()


def test_mesh_batcher_refuses_a_device_beside_a_mesh():
    model = torch_model(TINY_TAIL, jax_params(TINY_TAIL, seed=0))
    with pytest.raises(ValueError, match="not both"):
        ConvertBatcher(model, torch_cfg(TINY_TAIL), mesh=make_mesh(1, devices=["cpu"]), device="cpu")
