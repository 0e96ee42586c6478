"""The plain PyTorch versions of the port's four tensor-core kernels (K1-K4:
WaveNet stack, coupling block, MRF stage, decoder tail) against the Pallas
kernels they replace, run in interpret mode on the CPU.

Both sides start from the same seeded numpy weights and pack them their own
way.  In f32 the comparison pins the algebra (tap order, flips, phases,
masks) at the JAX suite's own bars; in bf16 it pins the rounding points:
max |Δ| ≤ 2⁻⁶·max|ref| and mean |Δ| ≤ 2⁻¹⁰·max|ref| (a different f32
summation order can flip a bf16 rounding, nothing more; the on-card check of
each kernel against its own plain version holds the same maximum and a
tighter mean).  On the CPU each wrapper runs its plain version, so these
tests go through the wrappers.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openvoice_tpu.nn.conv import conv1d as jconv1d
from openvoice_tpu.ops import coupling_pallas as jcp
from openvoice_tpu.ops import mrf_pallas as jmrf
from openvoice_tpu.ops import wn_pallas as jwn
from openvoice_tpu_torch.ckpt import from_jax
from openvoice_tpu_torch.nn.hifigan import ResBlock1
from openvoice_tpu_torch.nn.conv import conv1d, conv_transpose1d
from openvoice_tpu_torch.nn.wavenet import WN
from openvoice_tpu_torch.ops import _frag, coupling_cuda, mrf_cuda, tail_cuda, wn_cuda
from tests._torch_port import TINY, jax_params, t, torch_model

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _close_f32(out, ref, atol, rtol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def _close_bf16(out, ref):
    """The bf16 bars, relative to the reference's peak."""
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - ref)
    peak = np.abs(ref).max()
    assert diff.max() <= 2.0 ** -6 * peak, f"max |Δ| {diff.max():.3e} vs peak {peak:.3e}"
    assert diff.mean() <= 2.0 ** -10 * peak, f"mean |Δ| {diff.mean():.3e} vs peak {peak:.3e}"


def _cast(tree, dtype):
    import jax

    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


# -- K1 ------------------------------------------------------------------------

def _wn_params(rng, hidden, n_layers, k, gin):
    def arr(*shape):
        return (rng.standard_normal(shape) * 0.07).astype(np.float32)

    p = {"in": [], "res_skip": [], "cond": None}
    for i in range(n_layers):
        out = 2 * hidden if i < n_layers - 1 else hidden
        p["in"].append({"w": arr(k, hidden, 2 * hidden), "b": arr(2 * hidden)})
        p["res_skip"].append({"w": arr(1, hidden, out), "b": arr(out)})
    if gin:
        p["cond"] = {"w": arr(1, gin, 2 * hidden * n_layers), "b": arr(2 * hidden * n_layers)}
    return p


def _wn_case(n_layers, hidden, gin, t_len, dtype):
    """Seeded K1 inputs, as `test_wn_stack_matches_pallas` makes them: the
    Pallas kernel's result in interpret mode, and the port's inputs."""
    k, b = 5, 2
    rng = np.random.default_rng(n_layers * 100 + t_len)
    params = _wn_params(rng, hidden, n_layers, k, gin)
    sd: dict = {}
    from_jax._wn(params, "wn", sd)
    wn = _load(WN(hidden, k, n_layers, gin), {key[3:]: v for key, v in sd.items()})
    lengths = np.asarray([t_len, max(t_len - 37, 8)], np.int32)
    x = (rng.standard_normal((b, t_len, hidden)) * 0.5).astype(np.float32)
    g = rng.standard_normal((b, 1, gin)).astype(np.float32) if gin else None

    jdt = JDT[dtype]
    jp = _cast(params, jdt) if dtype != torch.float32 else params
    w_in, b_in, w_rs, b_rs = jwn.stack_wn_params(jp, hidden, dtype=jdt)
    if gin:
        g_stack = jconv1d(jnp.asarray(g, jdt), jp["cond"]["w"], jp["cond"]["b"]).reshape(b, n_layers, 2 * hidden)
    else:
        g_stack = jnp.zeros((b, n_layers, 2 * hidden), jdt)
    ref = jwn.fused_wn_stack(jnp.asarray(x, jdt), jnp.asarray(lengths), w_in, b_in, g_stack, w_rs, b_rs,
                             kernel_size=k, interpret=True)

    packed = wn_cuda.stack_wn_params(wn, dtype)
    if gin:
        g_all = wn.cond_layer.to(dtype)(t(g).to(dtype).transpose(1, 2)).reshape(b, n_layers, 2 * hidden)
    else:
        g_all = torch.zeros(b, n_layers, 2 * hidden, dtype=dtype)
    return t(x).to(dtype), t(lengths), packed, g_all, ref


WN_CASES = [(4, 64, 0, 96), (16, 32, 16, 120), (3, 64, 16, 56)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_layers,hidden,gin,t_len", WN_CASES)
@torch.inference_mode()
def test_wn_stack_matches_pallas(n_layers, hidden, gin, t_len, dtype):
    x, lengths, packed, g_all, ref = _wn_case(n_layers, hidden, gin, t_len, dtype)
    out = wn_cuda.wn_stack(x, lengths, packed, g_all)
    assert out.dtype == dtype and out.shape == x.shape
    assert bool((out[1, lengths[1]:] == 0).all())
    if dtype == torch.float32:
        _close_f32(out, ref, 1e-4, 1e-4)
    else:
        _close_bf16(out, ref)


def _wn_split_model(x, lengths, packed, g_all, ranks):
    """wn_stack as the cluster kernel (csrc/wn.cu) computes it: each of the
    `ranks` CTAs keeps its own copy of xs and acts and computes its channels
    of the WaveNet (`_wn_split_layers`); its output channels go straight to
    `out`."""
    dt = x.dtype
    b, t_len, h = x.shape
    mask = _frag.length_mask(lengths, t_len)
    xs = [x.float() * mask for _ in range(ranks)]
    acts = [torch.zeros(b, t_len, h) for _ in range(ranks)]
    out = torch.full((b, t_len, h), float("nan"))
    for ch, v in _wn_split_layers(xs, acts, mask, dt, packed["w_in"], packed["b_in"], g_all, packed["w_rs"],
                                  packed["b_rs"], _owned(h, ranks)):
        out[..., ch] = v
    _assert_copies_agree(xs, acts)
    return out.to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_layers,hidden,gin,t_len", WN_CASES)
@torch.inference_mode()
def test_wn_cluster_split_matches_pallas(n_layers, hidden, gin, t_len, dtype):
    """K1's split, modelled rank by rank, is the plain version bit for bit,
    and the Pallas kernel at the bars of the test above, for every cluster
    size the kernel takes (a rank may own no channel at R = 8, H = 32)."""
    x, lengths, packed, g_all, ref = _wn_case(n_layers, hidden, gin, t_len, dtype)
    plain = wn_cuda.wn_stack_plain(x, lengths, packed, g_all)
    for ranks in (1, 2, 4, 8):
        split = _wn_split_model(x, lengths, packed, g_all, ranks)
        assert torch.equal(split, plain), f"R = {ranks}: the split differs from wn_stack_plain"
        assert bool((split[1, lengths[1]:] == 0).all())
        if dtype == torch.float32:
            _close_f32(split, ref, 1e-4, 1e-4)
        else:
            _close_bf16(split, ref)


@pytest.mark.parametrize("length,live", [(0, 0), (1, 1), (200, 4)], ids=["0", "1", "full"])
@torch.inference_mode()
def test_wn_tiles_past_the_length_are_zero(length, live):
    """K1's early exit: a tile whose first frame lies at or past the length
    writes zeros and returns.  The plain version gives exactly 0 on every
    such tile and not on the tile before it, which `live_tiles` counts."""
    t_len, tile = 200, _frag.CLUSTER_TILE
    x, _, packed, g_all, _ = _wn_case(4, 32, 16, t_len, torch.float32)
    out = wn_cuda.wn_stack(x, torch.tensor([length, t_len]), packed, g_all)
    assert wn_cuda.live_tiles(length, tile, t_len) == live
    for i in range(-(-t_len // tile)):
        block = out[0, i * tile:(i + 1) * tile]
        assert bool((block == 0).all()) == (i >= live), (i, live)


# -- K2 ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flow_case():
    params = jax_params(TINY, seed=3)
    model = torch_model(TINY, params)
    rng = np.random.default_rng(7)
    b, t_len, c = 2, 64, TINY["inter_channels"]
    lengths = np.asarray([t_len, 41], np.int32)
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    x *= (np.arange(t_len)[None, :, None] < lengths[:, None, None])
    g = rng.standard_normal((b, 1, TINY["gin_channels"])).astype(np.float32)
    return params["flow"], model.flow, x, lengths, g


def _flow_both(flow_case, dtype, reverse, x=None):
    jflow, flow, x0, lengths, g = flow_case
    x = x0 if x is None else x
    jdt = JDT[dtype]
    jf = _cast(jflow, jdt) if dtype != torch.float32 else jflow
    k = jflow["layers"][0]["wn"]["in"][0]["w"].shape[0]
    jpacked = jcp.pack_coupling_block(jflow, TINY["hidden_channels"], reverse=reverse, dtype=jdt, kernel_size=k)
    jg = jcp.coupling_g_stack(jf, jnp.asarray(g, jdt), reverse=reverse, dtype=jdt)
    ref = jcp.fused_coupling_block(jnp.asarray(x, jdt), jnp.asarray(lengths), jpacked, jg,
                                   kernel_size=k, interpret=True)
    packed = coupling_cuda.pack_coupling_block(flow, reverse=reverse, dtype=dtype)
    convs = [layer.enc.cond_layer for layer in flow.flows[::2]]
    if dtype != torch.float32:
        import copy

        convs = [copy.deepcopy(c).to(dtype) for c in convs]
    g_all = coupling_cuda.coupling_g_stack(flow, t(g).to(dtype), reverse=reverse, convs=convs)
    out = coupling_cuda.coupling_block(t(np.asarray(x, np.float32)).to(dtype), t(lengths), packed, g_all)
    return out, ref


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@torch.inference_mode()
def test_coupling_block_matches_pallas(flow_case, dtype, reverse):
    out, ref = _flow_both(flow_case, dtype, reverse)
    lengths = flow_case[3]
    assert bool((out[1, lengths[1]:] == 0).all()), "frames past the length must be exactly 0"
    if dtype == torch.float32:
        _close_f32(out, ref, 2e-4, 1e-3)
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-3), (torch.bfloat16, 2.0 ** -5)], ids=["f32", "bf16"])
@torch.inference_mode()
def test_coupling_block_round_trip(flow_case, dtype, bar):
    x = flow_case[2]
    y, _ = _flow_both(flow_case, dtype, False)
    back, _ = _flow_both(flow_case, dtype, True, x=y.float().numpy())
    assert float((back.float() - t(x)).abs().max()) <= bar * float(np.abs(x).max())


@torch.inference_mode()
def test_coupling_exec_order_and_g_stack_follow_jax(flow_case):
    jflow, flow, _, _, g = flow_case
    for reverse in (False, True):
        assert coupling_cuda._exec_order(4, reverse) == jcp._exec_order(4, reverse)
        ours = coupling_cuda.coupling_g_stack(flow, t(g), reverse=reverse)
        ref = jcp.coupling_g_stack(jflow, jnp.asarray(g), reverse=reverse, dtype=jnp.float32)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_coupling_cluster_columns_partition(ranks):
    """Every output column of every product of K2, and of K1's two products,
    has exactly one owner in the cluster, a gate pair (tanh, sigmoid) and a
    channel's (res, skip) have the same one, and each rank owns whole
    8-column tiles, contiguous in each half."""
    from openvoice_tpu_torch.config import V2_CONVERTER_CONFIG as V2

    for c, h in [(V2.inter_channels, V2.hidden_channels), (TINY["inter_channels"], TINY["hidden_channels"])]:
        products = {"pre": (h, False), "gate": (2 * h, True), "res|skip": (2 * h, True), "post": (c, False),
                    "K1 gate": (2 * V2.hidden_channels, True), "K1 res|skip": (2 * V2.hidden_channels, True)}
        for name, (n_out, paired) in products.items():
            owned = _frag.cluster_columns(n_out, ranks, paired=paired)
            assert len(owned) == ranks
            flat = sorted(col for cols in owned for col in cols)
            assert flat == list(range(n_out)), f"{name}: a column without one owner"
            width = n_out // 2 if paired else n_out
            for cols in owned:
                halves = [sorted(col for col in cols if col < width), sorted(col - width for col in cols if col >= width)]
                if paired:
                    assert halves[0] == halves[1], f"{name}: a pair split between ranks"
                own = halves[0]
                if own:
                    assert own == list(range(own[0], own[-1] + 1)), f"{name}: not contiguous"
                    assert own[0] % 8 == 0 and len(own) % 8 == 0, f"{name}: not whole tiles"
            sizes = [len(cols) for cols in owned]
            assert max(sizes) - min(sizes) <= (16 if paired else 8), f"{name}: shares {sizes}"


def _store_all(copies, writes):
    """What the cluster barrier after a product leaves: every rank's columns
    stored into every rank's copy."""
    for cols, v in writes:
        for copy_ in copies:
            copy_[..., cols] = v


def _owned(n: int, ranks: int) -> list[torch.Tensor]:
    return [torch.tensor(cols, dtype=torch.long) for cols in _frag.cluster_columns(n, ranks)]


def _wn_split_layers(xs, acts, mask, dt, w_in, b_in, g_all, w_rs, b_rs, own_h):
    """The WaveNet layers as the cluster kernels compute them
    (csrc/wn_cluster.cuh::wn_cluster_layers).  `xs` and `acts` are the
    ranks' copies of the window; in every product each rank reads its own
    copy and computes only the channels `own_h` gives it, and only after all
    ranks have computed are the results stored into every copy (the cluster
    barrier).  The skip sum holds a rank's own channels.  Products in f32,
    in the kernel's rounding points.  Returns each rank's (channels, output):
    its skip sum rounded once and masked."""
    n_layers, k, h, _ = w_in.shape
    pad = (k - 1) // 2
    t_len = xs[0].shape[1]
    skip = [None] * len(own_h)
    for layer in range(n_layers):
        wi, bi = w_in[layer].float(), b_in[layer].float()
        wr, br = w_rs[layer].float(), b_rs[layer].float()
        g = g_all[:, layer : layer + 1].float()
        writes = []
        for r, ch in enumerate(own_h):
            xp = torch.nn.functional.pad(xs[r], (0, 0, pad, pad))
            tanh_in = sum(xp[:, j : j + t_len] @ wi[j][:, ch] for j in range(k)) + bi[ch] + g[..., ch]
            sig_in = sum(xp[:, j : j + t_len] @ wi[j][:, h + ch] for j in range(k)) + bi[h + ch] + g[..., h + ch]
            writes.append((ch, (torch.tanh(tanh_in) * torch.sigmoid(sig_in)).to(dt).float()))
        _store_all(acts, writes)
        writes = []
        for r, ch in enumerate(own_h):
            rs_skip = acts[r] @ wr[:, h + ch] + br[h + ch]
            skip[r] = rs_skip if layer == 0 else skip[r] + rs_skip
            if layer < n_layers - 1:
                res = (acts[r] @ wr[:, ch] + br[ch]).to(dt).float()
                writes.append((ch, (xs[r][..., ch] + res).to(dt).float() * mask))
        _store_all(xs, writes)
    return [(ch, skip[r].to(dt).float() * mask) for r, ch in enumerate(own_h)]


def _assert_copies_agree(*buffers):
    for copies in buffers:
        assert all(torch.equal(copies[0], other) for other in copies[1:]), "the copies diverged"


def _cluster_split_model(x, lengths, packed, g_all, ranks):
    """coupling_block as the cluster kernel (csrc/coupling.cu) computes it:
    each of the `ranks` CTAs keeps its own copy of the state, hs and acts,
    and computes its columns of the pre and post products and its channels
    of the WaveNet (`_wn_split_layers`), whose output goes, rounded and
    masked, into hs, which the post product reads."""
    dt = x.dtype
    b, t_len, c = x.shape
    n_steps, n_layers, k, h, _ = packed["w_in"].shape
    mask = _frag.length_mask(lengths, t_len)
    own_h, own_c = _owned(h, ranks), _owned(c, ranks)
    state = [x.float() * mask for _ in range(ranks)]
    hs = [torch.zeros(b, t_len, h) for _ in range(ranks)]
    acts = [torch.zeros(b, t_len, h) for _ in range(ranks)]
    for s in range(n_steps):
        wp, bp = packed["wp"][s].float(), packed["bp"][s].float()
        _store_all(hs, [(ch, (state[r] @ wp[:, ch] + bp[ch]).to(dt).float() * mask) for r, ch in enumerate(own_h)])
        _store_all(hs, _wn_split_layers(hs, acts, mask, dt, packed["w_in"][s], packed["b_in"][s], g_all[:, s],
                                        packed["w_rs"][s], packed["b_rs"][s], own_h))
        wq, bq = packed["wq"][s].float(), packed["bq"][s].float()
        _store_all(state, [(cols, (state[r][..., cols] + (hs[r] @ wq[:, cols] + bq[cols]).to(dt).float()).to(dt).float()
                            * mask) for r, cols in enumerate(own_c)])
    _assert_copies_agree(state, hs, acts)
    return state[0].to(dt)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@torch.inference_mode()
def test_coupling_cluster_split_matches_pallas(flow_case, dtype, reverse):
    """The kernel's split, modelled rank by rank, is the plain version bit
    for bit, and the Pallas kernel at the bars of the test above."""
    out, ref = _flow_both(flow_case, dtype, reverse)
    _, flow, x, lengths, g = flow_case
    packed = coupling_cuda.pack_coupling_block(flow, reverse=reverse, dtype=dtype)
    convs = [copy.deepcopy(layer.enc.cond_layer).to(dtype) for layer in flow.flows[::2]]
    g_all = coupling_cuda.coupling_g_stack(flow, t(g).to(dtype), reverse=reverse, convs=convs)
    for ranks in (1, 2, 4):
        split = _cluster_split_model(t(x).to(dtype), t(lengths), packed, g_all, ranks)
        assert torch.equal(split, out), f"R = {ranks}: the split differs from coupling_block_plain"
        assert bool((split[1, lengths[1]:] == 0).all())
        if dtype == torch.float32:
            _close_f32(split, ref, 2e-4, 1e-3)
        else:
            _close_bf16(split, ref)


# -- K3 / K4 -------------------------------------------------------------------

def _random_resblocks(rng, c):
    def conv(k):
        return {"w": (rng.standard_normal((k, c, c)) * 0.05).astype(np.float32),
                "b": (rng.standard_normal(c) * 0.05).astype(np.float32)}

    return [{"convs1": [conv(k) for _ in range(3)], "convs2": [conv(k) for _ in range(3)]} for k in KS]


def _torch_resblocks(jrbs, c):
    out = []
    for rb, k, dils in zip(jrbs, KS, DILS):
        sd: dict = {}
        for name in ("convs1", "convs2"):
            for j, conv in enumerate(rb[name]):
                from_jax._conv(conv, f"{name}.{j}", sd)
        out.append(_load(ResBlock1(c, k, dils), sd))
    return out


def test_stage_halo_is_the_jax_halo():
    assert mrf_cuda.stage_halo(KS, DILS) == jmrf.stage_halo(KS, DILS) == 60


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,t_len", [(32, 1030), (64, 1203)])
@torch.inference_mode()
def test_mrf_stage_matches_pallas(c, t_len, dtype):
    rng = np.random.default_rng(c + t_len)
    jrbs = _random_resblocks(rng, c)
    b = 2
    lengths = np.asarray([t_len, t_len - 321], np.int32)
    x = (rng.standard_normal((b, t_len, c)) * 0.5).astype(np.float32)

    jdt = JDT[dtype]
    w_all, b_all, _ = jmrf.pack_stage_weights(jrbs, KS, DILS, dtype=jdt)
    ref = jmrf.fused_mrf_stage(jnp.asarray(x, jdt), jnp.asarray(lengths), w_all, b_all,
                               kernel_sizes=KS, dilation_sizes=DILS, interpret=True)
    packed = mrf_cuda.pack_stage_weights(_torch_resblocks(jrbs, c), dtype)
    assert packed["kernel_sizes"] == KS and packed["dilation_sizes"] == DILS
    out = mrf_cuda.mrf_stage(t(x).to(dtype), t(lengths), packed)
    assert out.dtype == dtype and out.shape == (b, t_len, c)
    assert bool((out[1, lengths[1]:] == 0).all())
    if dtype == torch.float32:
        _close_f32(out, ref, 1e-4, 1e-4)
    else:
        _close_bf16(out, ref)


def _window_model(x, length, packed, pos0, rows, ranges, dt):
    """One K3 block's window in plain torch: x [T, C] (values of `dt`), the
    window rows pos0 .. pos0 + rows, conv j computed only on its window rows
    ranges[j] = [lo, hi) and NaN on every other row (where the kernel leaves
    stale values), zeros read past the window's edges as from the kernel's
    zero row.  Returns the mean of the branches on every window row."""
    t_len, c = x.shape
    pos = pos0 + torch.arange(rows)
    live = ((pos >= 0) & (pos < length)).float()[:, None]
    x0 = torch.zeros(rows, c)
    inside = (pos >= 0) & (pos < t_len)
    x0[inside] = x[pos[inside]].float()
    x0 = x0 * live
    w, b = packed["w"], packed["b"]
    acc = torch.zeros(rows, c)
    tap = conv = 0

    def run(operand, taps, bias, d, rng, epilogue):
        y = mrf_cuda._conv_plain(operand[None], taps, bias, d)[0]
        out = torch.full((rows, c), float("nan"))
        lo, hi = rng
        out[lo:hi] = epilogue(y[lo:hi], slice(lo, hi))
        return out

    for k, dils in zip(packed["kernel_sizes"], packed["dilation_sizes"]):
        xb = x0
        for d in dils:
            a = mrf_cuda.lrelu_plain(xb, mrf_cuda.LRELU_SLOPE, dt) * live
            xt = run(a, w[tap:tap + k], b[conv], d, ranges[conv], lambda y, r: torch.where(
                live[r] > 0, mrf_cuda.lrelu_plain(y.to(dt).float(), mrf_cuda.LRELU_SLOPE, dt), 0.0))
            xb = run(xt, w[tap + k:tap + 2 * k], b[conv + 1], 1, ranges[conv + 1], lambda y, r, xb=xb: torch.where(
                live[r] > 0, (xb[r] + y.to(dt).float()).to(dt).float(), 0.0))
            tap += 2 * k
            conv += 2
        acc = acc + xb * live
    return acc / len(packed["kernel_sizes"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@torch.inference_mode()
def test_mrf_trimmed_rows_keep_the_stage(dtype):
    """K3 computes each conv only on the rows `mrf_cuda.conv_ranges` gives
    (the kept tile widened by the reaches of the convs after it).  A window
    computed so, with NaN on every other row, keeps its tile finite and equal
    to `mrf_stage_plain` (and so to the Pallas kernel), and each range is
    the least that suffices: a row fewer on either side reaches the tile."""
    c, t_len, length, tile = 16, 700, 650, 40
    rng = np.random.default_rng(16)
    jrbs = _random_resblocks(rng, c)
    x = (rng.standard_normal((1, t_len, c)) * 0.5).astype(np.float32)
    halo = mrf_cuda.stage_halo(KS, DILS)
    rows = tile + 2 * halo
    ranges = mrf_cuda.conv_ranges(KS, DILS, halo, tile)
    assert len(ranges) == 18 and ranges[-1] == (halo, halo + tile) and ranges[12] == (5, rows - 5)

    jdt = JDT[dtype]
    w_all, b_all, _ = jmrf.pack_stage_weights(jrbs, KS, DILS, dtype=jdt)
    pallas = jmrf.fused_mrf_stage(jnp.asarray(x, jdt), jnp.asarray([length], np.int32), w_all, b_all,
                                  kernel_sizes=KS, dilation_sizes=DILS, interpret=True)
    packed = mrf_cuda.pack_stage_weights(_torch_resblocks(jrbs, c), dtype)
    xt = t(x).to(dtype)
    plain = mrf_cuda.mrf_stage_plain(xt, t(np.asarray([length])), packed)
    close = (lambda o, r: _close_f32(o, r, 1e-4, 1e-4)) if dtype == torch.float32 else _close_bf16
    close(plain, pallas)

    # windows at the clip's start, inside it, and across its length and end
    for pos0 in (-halo, 100, length - halo - tile // 2, t_len - halo - tile // 2):
        got = _window_model(xt[0], length, packed, pos0, rows, ranges, dtype)[halo:halo + tile]
        n = min(tile, t_len - pos0 - halo)
        assert bool(torch.isfinite(got).all())
        close(got[:n].to(dtype), plain[0, pos0 + halo:pos0 + halo + n].float().numpy())

    # a fully live window: shrinking any conv's range by one row spoils the tile
    pos0 = 100
    for j, (lo, hi) in enumerate(ranges):
        for shrunk in ((lo + 1, hi), (lo, hi - 1)):
            trial = ranges[:j] + [shrunk] + ranges[j + 1:]
            got = _window_model(xt[0], length, packed, pos0, rows, trial, dtype)[halo:halo + tile]
            assert not bool(torch.isfinite(got).all()), (j, shrunk)


class _SmemStandIn:
    """The K3 library's shared-memory size, as ``csrc/mrf.cu::
    mrf_stage_smem_bytes`` computes it (alignment room, the ring's slabs of
    32·C bytes, two barriers a ring group, a zero row and two [rows, C]
    bf16 buffers), so that `launch_plan` runs without the card."""

    @staticmethod
    def mrf_stage_smem_bytes(c, rows, slabs, stages):
        return 256 + slabs * 32 * c + 16 * max(stages, 1) + (1 + 2 * rows) * c * 2


def _plan_entries(plan) -> list[tuple]:
    """A kernel's ctypes plan table as (first, count, steps, slab0,
    group_end) entries."""
    flat = list(plan)
    return [tuple(flat[i:i + 5]) for i in range(0, len(flat), 5)]


@pytest.mark.parametrize("c,t_len,rows,stages", [
    (256, 8192, 192, 4), (128, 65536, 384, 8),    # a 1024-frame bucket's two stages
    (256, 1024, 192, 4), (128, 8192, 384, 8),     # bucket 128, the shortest batcher and stream bucket
    (256, 40, 192, 4), (128, 100, 256, 16)],      # shorter than one tile
    ids=["c256-bucket1024", "c128-bucket1024", "c256-bucket128", "c128-bucket128", "c256-short", "c128-short"])
def test_mrf_conv_tiles_cover_the_ranges(monkeypatch, c, t_len, rows, stages):
    """K3's row plan: each conv's 64-row tiles cover its range, lie inside
    the window, start at the range's first row unless the window's end moves
    them back, and reach past the range only into rows no later conv of the
    branch reads within its own range; the kept rows, which `out` takes, lie
    inside every range.  Each branch's last conv has the same tiles (the
    threads that park a branch's rows sum them).  The ring holds `stages`
    slabs in whole groups."""
    monkeypatch.setattr(mrf_cuda, "_library", lambda: _SmemStandIn)
    monkeypatch.setattr(mrf_cuda, "_PLANS", {})
    monkeypatch.setattr(_frag, "_WINDOWS", {})
    got_rows, tile, groups, group, width, plan = mrf_cuda.launch_plan(c, t_len, KS, DILS)
    assert (got_rows, groups * group, width) == (rows, stages, c)
    assert group == mrf_cuda.ring_group(width)
    item = mrf_cuda.TILE_M
    assert _SmemStandIn.mrf_stage_smem_bytes(c, rows, stages, groups) <= _frag.SMEM_MAX
    halo = mrf_cuda.stage_halo(KS, DILS)
    assert rows - tile == 2 * halo and (tile >= t_len or rows == 192 or rows == 384)
    tiles = [entry[:2] for entry in _plan_entries(plan)]
    ranges = mrf_cuda.conv_ranges(KS, DILS, halo, tile)
    assert tiles == mrf_cuda.conv_tiles(KS, DILS, halo, tile, rows) and len(tiles) == 18
    for j, ((lo, hi), (first, count)) in enumerate(zip(ranges, tiles)):
        end = first + count * item
        assert 0 <= first <= lo and hi <= end <= rows
        assert first == lo or end == rows
        assert lo <= halo and halo + tile <= hi       # the kept rows lie inside the range
        assert end - hi < item and count == -(-(hi - lo) // item)
        if j % 6 < 5:                                  # later convs of the branch read only inside this range
            reach = mrf_cuda.conv_reaches(KS[j // 6], DILS[j // 6])[j % 6 + 1]
            nlo, nhi = ranges[j + 1]
            assert lo <= nlo - reach and nhi + reach <= hi
    assert len(set(tiles[5::6])) == 1


@pytest.mark.parametrize("c,t_len", [
    (256, 8192), (128, 65536),    # V2's two K3 stages at a 1024-frame bucket
    (256, 6144), (128, 49152),    # MeloTTS's at its median line's 768-frame bucket
    (256, 40), (128, 100)],       # shorter than one tile
    ids=["v2-c256", "v2-c128", "melo-c256", "melo-c128", "c256-short", "c128-short"])
def test_mrf_ring_plan_matches_the_device_formula(monkeypatch, c, t_len):
    """K3's ring plan, built on the host, walks the ring as the plan its
    kernel once built on the device did: for each conv the same group end,
    groups a round and first group, with groups of as many slabs (2 at
    C = 256, 4 at 128, which the products of a warpgroup took at once)."""
    monkeypatch.setattr(mrf_cuda, "_library", lambda: _SmemStandIn)
    monkeypatch.setattr(mrf_cuda, "_PLANS", {})
    monkeypatch.setattr(_frag, "_WINDOWS", {})
    rows, tile, _, group, width, plan = mrf_cuda.launch_plan(c, t_len, KS, DILS)
    tiles = mrf_cuda.conv_tiles(KS, DILS, mrf_cuda.stage_halo(KS, DILS), tile, rows)
    # the device's formula: G slabs a group, a round's groups taps x k-tiles / G,
    # ceil(tiles x parts / warpgroups) rounds, the convs' groups one after another
    g, k_tiles, parts, warpgroups = (2 if width >= 256 else 4), c // 16, c // width, 3
    end = first = 0
    device = []
    for cv, (_, count) in enumerate(tiles):
        round_groups = KS[cv // (2 * len(DILS[0]))] * k_tiles // g
        end += -(-count * parts // warpgroups) * round_groups
        device.append((end, round_groups, first))
        first += round_groups
    assert group == g and mrf_cuda.WARPGROUPS == warpgroups
    host = [(group_end, -(-steps // group), slab0 // group)
            for _, _, steps, slab0, group_end in _plan_entries(plan)]
    assert all(slab0 % group == 0 for _, _, _, slab0, _ in _plan_entries(plan))
    assert host == device


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [192, 384], ids=["c256-window", "c128-window"])
@torch.inference_mode()
def test_mrf_tile_spans_keep_the_stage(rows, dtype):
    """The rows K3's 64-row tiles compute past a conv's range hold values
    made from stale rows: a window computed on the tiles' whole spans, with
    NaN on every row outside them, keeps its tile finite and equal to
    `mrf_stage_plain`, at the clip's start, inside it and across its end,
    in the windows the plan gives C = 256 and C = 128."""
    c, t_len, length = 16, 900, 850
    rng = np.random.default_rng(17)
    jrbs = _random_resblocks(rng, c)
    x = (rng.standard_normal((1, t_len, c)) * 0.5).astype(np.float32)
    halo = mrf_cuda.stage_halo(KS, DILS)
    tile = rows - 2 * halo
    spans = [(first, first + count * mrf_cuda.TILE_M)
             for first, count in mrf_cuda.conv_tiles(KS, DILS, halo, tile, rows)]
    assert any(s != r for s, r in zip(spans, mrf_cuda.conv_ranges(KS, DILS, halo, tile)))
    packed = mrf_cuda.pack_stage_weights(_torch_resblocks(jrbs, c), dtype)
    xt = t(x).to(dtype)
    plain = mrf_cuda.mrf_stage_plain(xt, t(np.asarray([length])), packed)
    close = (lambda o, r: _close_f32(o, r, 1e-4, 1e-4)) if dtype == torch.float32 else _close_bf16
    for pos0 in (-halo, 100, length - halo - tile // 2, t_len - halo - tile // 2):
        got = _window_model(xt[0], length, packed, pos0, rows, spans, dtype)[halo:halo + tile]
        n = min(tile, t_len - pos0 - halo)
        assert bool(torch.isfinite(got).all())
        close(got[:n].to(dtype), plain[0, pos0 + halo:pos0 + halo + n].float().numpy())


@pytest.mark.parametrize("c", [128, 256])
def test_mrf_wgmma_slabs_give_back_the_weights(c):
    """`pack_slabs`, read back by byte address: element W[k, n] of slab
    (tap, k // 16) sits at byte 32·n + 2·(k % 16) of the slab with bit 4 of
    the address XOR bit 7 (the 32-byte swizzle wgmma's descriptor names).
    Every conv's dense [tap][C_in][C_out] weights come back exactly."""
    gen = torch.Generator().manual_seed(c)
    rbs = [ResBlock1(c, k, d) for k, d in zip(KS, DILS)]
    with torch.no_grad():
        for rb in rbs:
            for p in rb.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
    packed = mrf_cuda.pack_stage_weights(rbs)
    w, slabs = packed["w"], packed["w_slabs"]
    assert slabs.shape == (w.shape[0], c // 16, c, 16) and slabs.dtype == torch.bfloat16 and slabs.is_contiguous()
    k = np.arange(c)[:, None]
    n = np.arange(c)[None, :]
    byte = 32 * n + 2 * (k % 16)
    byte = byte ^ (((byte >> 7) & 1) << 4)
    flat = slabs.view(torch.int16).reshape(w.shape[0], c // 16, c * 16)
    dense = flat[:, torch.from_numpy(k // 16 + 0 * n), torch.from_numpy(byte // 2)]
    assert torch.equal(dense, w.view(torch.int16))
    tap = 0
    for rb in rbs:
        for conv in (m for pair in zip(rb.convs1, rb.convs2) for m in pair):
            size = conv.kernel_size[0]
            assert torch.equal(dense[tap:tap + size].view(torch.bfloat16),
                               conv.weight.detach().permute(2, 1, 0).to(torch.bfloat16))
            tap += size
    assert tap == w.shape[0]
    assert _frag.pack_slabs(torch.zeros(3, 48, 48)) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c_in,c_out,t_in,last,k_up", [
    (128, 64, 301, False, 4), (64, 32, 403, True, 4),
    # MeloTTS's stages 2-4: upsample kernels 8 and 2, the last at 16 channels
    (128, 64, 233, False, 8), (64, 32, 257, False, 2), (32, 16, 281, True, 2),
], ids=["middle", "last", "melo-stage2", "melo-stage3", "melo-stage4"])
@torch.inference_mode()
def test_tail_stage_matches_pallas(c_in, c_out, t_in, last, k_up, dtype):
    u = 2
    rng = np.random.default_rng(c_in + t_in)
    jrbs = _random_resblocks(rng, c_out)
    up = {"w": (rng.standard_normal((k_up, c_in, c_out)) * 0.1).astype(np.float32),
          "b": (rng.standard_normal(c_out) * 0.1).astype(np.float32)}
    post_w = (rng.standard_normal((7, c_out, 1)) * 0.1).astype(np.float32) if last else None
    b = 2
    lengths_in = np.asarray([t_in, t_in - 111], np.int32)
    x = (rng.standard_normal((b, t_in, c_in)) * 0.5).astype(np.float32)
    x *= (np.arange(t_in)[None, :, None] < lengths_in[:, None, None])

    jdt = JDT[dtype]
    fold = 128 // c_out
    w_all, b_all, up_qs, mrf_meta, post_qs = jmrf.pack_tail_weights(
        _cast(up, jnp.float32), jrbs, None if post_w is None else jnp.asarray(post_w), KS, DILS,
        stride=u, up_padding=(k_up - u) // 2, fold=fold, dtype=jdt)
    ref = jmrf.fused_tail_stage(
        jnp.asarray(x, jdt), jnp.asarray(lengths_in * u), w_all, b_all, kernel_sizes=KS,
        dilation_sizes=DILS, stride=u, fold=fold, up_qs=up_qs, mrf_meta=mrf_meta, post_qs=post_qs,
        interpret=True)

    sd: dict = {}
    from_jax._conv_transpose(up, "up", sd)
    up_mod = _load(conv_transpose1d(c_in, c_out, k_up, u), {key[3:]: v for key, v in sd.items()})
    post_mod = None
    if last:
        sd = {}
        from_jax._conv({"w": post_w, "b": None}, "post", sd)
        post_mod = _load(conv1d(c_out, 1, 7, bias=False), {key[5:]: v for key, v in sd.items()})
    packed = tail_cuda.pack_tail_weights(up_mod, _torch_resblocks(jrbs, c_out), post_mod, dtype)
    out = tail_cuda.tail_stage(t(x).to(dtype), t(lengths_in * u), packed)
    assert out.dtype == dtype and out.shape == (b, t_in * u, 1 if last else c_out)
    # activations are exactly 0 past the length; the audio only past conv_post's
    # reach beyond it, in the Pallas kernel as here
    assert bool((out[1, lengths_in[1] * u + (3 if last else 0):] == 0).all())
    if dtype == torch.float32:
        _close_f32(out, ref, 1e-4, 1e-4)
    else:
        _close_bf16(out, ref)


def _tail_packed(rng, c_in, c_out, last, dtype, k_up=4):
    """A tail stage's packed weights from seeded numpy draws: upsample ×2
    (k 4, the V2 stages'; MeloTTS's take 8 and 2), the V2 branches, and
    conv_post (k 7) on the last stage."""
    up = {"w": (rng.standard_normal((k_up, c_in, c_out)) * 0.1).astype(np.float32),
          "b": (rng.standard_normal(c_out) * 0.1).astype(np.float32)}
    sd: dict = {}
    from_jax._conv_transpose(up, "up", sd)
    up_mod = _load(conv_transpose1d(c_in, c_out, k_up, 2), {key[3:]: v for key, v in sd.items()})
    post_mod = None
    if last:
        sd = {}
        from_jax._conv({"w": (rng.standard_normal((7, c_out, 1)) * 0.1).astype(np.float32), "b": None}, "post", sd)
        post_mod = _load(conv1d(c_out, 1, 7, bias=False), {key[5:]: v for key, v in sd.items()})
    return tail_cuda.pack_tail_weights(up_mod, _torch_resblocks(_random_resblocks(rng, c_out), c_out), post_mod,
                                       dtype)


def _tail_window_model(x, lengths, packed, t0, rows, tile, tiles, dt):
    """One K4 block (csrc/tail.cu) in plain torch: the tile starting at
    output sample t0 with its window of `rows` rows around it.  Every value
    the block holds lives on a canvas of the whole batch's shape, so that
    each conv runs as `tail_stage_plain` runs it; canvas rows outside the
    window are 0 (the kernel's zero row), and window rows a conv does not
    compute (outside the span of its 64-row `tiles`) are NaN, where the
    kernel leaves stale values; the rows a span computes past the conv's
    range are computed from what its operand holds, stale rows included.
    The staged input covers the input rows the upsample's phases reach.
    Returns the block's output rows [B, tile, C] (or the audio [B, tile, 1]
    on the last stage)."""
    batch, t_in, _ = x.shape
    stride, post = packed["stride"], packed["post_w"]
    t_out = t_in * stride
    post_half = (post.shape[0] - 1) // 2 if post is not None else 0
    halo = (rows - tile) // 2
    pos0 = t0 - halo
    margin = tail_cuda._in_margin(packed["up_w"].shape[0], stride, packed["pad_up"])
    mask_in = _frag.length_mask(lengths // stride, t_in)
    mask = _frag.length_mask(lengths, t_out)
    pos = torch.arange(t_out)[None, :, None]
    window = (pos >= pos0) & (pos < pos0 + rows)

    def rows_of(lo, hi):  # window rows [lo, hi) on the canvas
        return (pos >= pos0 + lo) & (pos < pos0 + hi)

    m = torch.arange(t_in)[None, :, None]
    staged = (m >= pos0 // stride - margin) & (m < (pos0 + rows) // stride + margin)
    xin = torch.where(staged, mrf_cuda.lrelu_plain(x.float(), mrf_cuda.LRELU_SLOPE, dt) * mask_in, 0.0)
    y = F.conv_transpose1d(xin.transpose(1, 2), packed["up_w"].float().permute(1, 2, 0), packed["up_b"].float(),
                           stride=stride, padding=packed["pad_up"]).transpose(1, 2)
    x0 = torch.where(window, y.to(dt).float() * mask, 0.0)

    def conv(operand, taps, bias, d, span, epilogue):
        lo, hi = span[0], span[0] + span[1] * mrf_cuda.TILE_M
        out = mrf_cuda._conv_plain(operand, taps, bias, d)
        return torch.where(rows_of(lo, hi), epilogue(out), torch.where(window, float("nan"), 0.0))

    w, b = packed["w"], packed["b"]
    acc = torch.zeros_like(x0)
    tap = cv = 0
    for k, dils in zip(packed["kernel_sizes"], packed["dilation_sizes"]):
        xb = x0
        for d in dils:
            xt = conv(mrf_cuda.lrelu_plain(xb, mrf_cuda.LRELU_SLOPE, dt), w[tap:tap + k], b[cv], d, tiles[cv],
                      lambda v: mrf_cuda.lrelu_plain(v.to(dt).float(), mrf_cuda.LRELU_SLOPE, dt) * mask)
            xb = conv(xt, w[tap + k:tap + 2 * k], b[cv + 1], 1, tiles[cv + 1],
                      lambda v, xb=xb: (xb + v.to(dt).float()).to(dt).float() * mask)
            tap += 2 * k
            cv += 2
        acc = acc + xb * mask
    mean = acc / len(packed["kernel_sizes"])
    if post is None:
        return mean.to(dt)[:, t0:t0 + tile]
    kept = rows_of(halo - post_half, halo + tile + post_half)
    ym = torch.where(kept, mrf_cuda.lrelu_plain(mean.to(dt).float(), tail_cuda.POST_SLOPE, dt),
                     torch.where(window, float("nan"), 0.0))
    audio = F.conv1d(ym.transpose(1, 2), post.float().t()[None], padding=post_half)
    return torch.tanh(audio).transpose(1, 2).to(dt)[:, t0:t0 + tile]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c_in,c_out,t_in,last,k_up", [
    (128, 64, 301, False, 4), (64, 32, 403, True, 4),
    (128, 64, 301, False, 8), (64, 32, 403, False, 2), (32, 16, 405, True, 2)],
    ids=["middle", "last", "melo-stage2", "melo-stage3", "melo-stage4"])
@torch.inference_mode()
def test_tail_trimmed_rows_keep_the_stage(c_in, c_out, t_in, last, k_up, dtype):
    """K4 computes each MRF conv only on the 64-row tiles
    `tail_cuda.tail_tiles` gives (on the last stage the kept rows reach
    conv_post's half width past the tile).  Blocks computed so, on the
    tiles' whole spans and with NaN on every other row of their windows,
    give `tail_stage_plain` bit for bit on every tile, and on the last stage
    the tiles of the tile alone let NaN reach the audio.  Also at MeloTTS's
    stages 2-4: upsample kernels 8 (the staged input reaches 2 rows past the
    window a side) and 2 (no row past it), 16 channels."""
    rng = np.random.default_rng(c_in + t_in + 7)
    packed = _tail_packed(rng, c_in, c_out, last, dtype, k_up)
    lengths = torch.tensor([t_in * 2, (t_in - 111) * 2])
    x = torch.from_numpy((rng.standard_normal((2, t_in, c_in)) * 0.5).astype(np.float32)).to(dtype)
    plain = tail_cuda.tail_stage(x, lengths, packed)
    post_half = 3 if last else 0
    rows = 256
    halo = tail_cuda.tail_halo(KS, DILS, 7 if last else 0, 2)
    assert halo == (64 if last else 60)
    tile = rows - 2 * halo
    tiles = tail_cuda.tail_tiles(KS, DILS, halo, tile, rows, post_half)
    # each branch's last conv computes the same tiles (the kernel's threads
    # park and sum their own elements), around the kept rows
    (first, count), = set(tiles[5::6])
    assert first <= halo - post_half and halo + tile + post_half <= first + count * mrf_cuda.TILE_M
    t_out = t_in * 2
    for t0 in range(0, t_out, tile):
        got = _tail_window_model(x, lengths, packed, t0, rows, tile, tiles, dtype)
        n = min(tile, t_out - t0)
        assert bool(torch.isfinite(got[:, :n].float()).all()), t0
        assert torch.equal(got[:, :n], plain[:, t0:t0 + n]), t0
    if last:
        narrow = tail_cuda.tail_tiles(KS, DILS, halo, tile, rows, 0)
        got = _tail_window_model(x, lengths, packed, tile, rows, tile, narrow, dtype)
        assert not bool(torch.isfinite(got.float()).all())


class _TailSmemStandIn:
    """The K4 library's shared-memory size, as ``csrc/tail.cu::smem_bytes``
    computes it (alignment room, the ring's or the resident stream's slabs
    of 32·C bytes, two barriers a ring group or one for the resident
    stream, a zero row, the window's three padded buffers, the third also
    the staged input's, and the biases), so that `launch_plan` runs without
    the card."""

    @staticmethod
    def tail_stage_smem_bytes(cin, c, stride, margin, rows, n_convs, slabs, stages):
        ld, ldin = c + 8, cin + 8
        xt = max(rows * ld, (rows // stride + 2 * margin) * ldin)
        return 256 + slabs * 32 * c + 16 * max(stages, 1) + 2 * (max(ld, ldin) + 2 * rows * ld + xt + (1 + n_convs) * c)


@pytest.mark.parametrize("cin,c,k_up,pad,k_post,t_out,rows,stages,group", [
    (128, 64, 4, 1, 0, 1024 * 128, 448, 2, 8), (128, 64, 4, 1, 0, 128 * 128, 448, 2, 8),    # V2 stage 2
    (64, 32, 4, 1, 7, 1024 * 256, 768, 2, 16), (64, 32, 4, 1, 7, 128 * 256, 768, 2, 16),   # V2 stage 3
    (32, 16, 2, 0, 7, 1024 * 512, 768, 0, 16),                                              # MeloTTS stage 4
    (64, 32, 4, 1, 7, 200, 384, 8, 16)],                                                    # shorter than a tile
    ids=["v2-stage2-bucket1024", "v2-stage2-bucket128", "v2-stage3-bucket1024", "v2-stage3-bucket128",
         "melo-stage4-bucket1024", "v2-stage3-short"])
def test_tail_tiles_cover_the_ranges(monkeypatch, cin, c, k_up, pad, k_post, t_out, rows, stages, group):
    """K4's launch plan: the window is a multiple of 64 rows and of the
    stride, and it fits one block's shared memory with its ring (or, at
    C = 16, the whole resident weight stream: stages 0).  Each MRF conv's
    64-row tiles cover its range, which on the last stage reaches
    conv_post's half width past the kept rows, lie inside the window, start
    at the range's first row unless the window's end moves them back, and
    reach past the range only into rows no later conv of the branch reads
    within its own range.  Each branch's last conv has the same tiles (the
    threads that park a branch's rows sum them)."""
    monkeypatch.setattr(tail_cuda, "_library", lambda: _TailSmemStandIn)
    monkeypatch.setattr(tail_cuda, "_PLANS", {})
    monkeypatch.setattr(_frag, "_WINDOWS", {})
    got_rows, tile, halo, got_stages, got_group, ring_slabs, plan, smem = tail_cuda.launch_plan(
        cin, c, t_out, k_up, 2, pad, k_post, KS, DILS)
    assert (got_rows, got_stages, got_group) == (rows, stages, group)
    margin = tail_cuda._in_margin(k_up, 2, pad)
    n_slabs = tail_cuda.stream_slabs(cin, c, k_up, KS, DILS)
    assert ring_slabs == (n_slabs if stages == 0 else stages * group) and stages <= _frag.MAX_STAGES
    assert smem == _TailSmemStandIn.tail_stage_smem_bytes(cin, c, 2, margin, rows, 18, ring_slabs, stages)
    assert smem <= _frag.SMEM_MAX
    item = mrf_cuda.TILE_M
    post_half = max(k_post - 1, 0) // 2
    assert rows % item == 0 and rows % 2 == 0 and halo % 2 == 0 and rows - tile == 2 * halo
    assert halo == tail_cuda.tail_halo(KS, DILS, k_post, 2) and (tile >= t_out or t_out > 1000)
    tiles = [entry[:2] for entry in _plan_entries(plan)[2:]]   # after the stride's two phases
    assert tiles == tail_cuda.tail_tiles(KS, DILS, halo, tile, rows, post_half) and len(tiles) == 18
    ranges = mrf_cuda.conv_ranges(KS, DILS, halo - post_half, tile + 2 * post_half)
    for j, ((lo, hi), (first, count)) in enumerate(zip(ranges, tiles)):
        end = first + count * item
        assert 0 <= first <= lo and hi <= end <= rows
        assert first == lo or end == rows
        assert lo <= halo - post_half and halo + tile + post_half <= hi   # the kept rows lie inside the range
        assert end - hi < item and count == -(-(hi - lo) // item)
        if j % 6 < 5:                                  # later convs of the branch read only inside this range
            reach = mrf_cuda.conv_reaches(KS[j // 6], DILS[j // 6])[j % 6 + 1]
            nlo, nhi = ranges[j + 1]
            assert lo <= nlo - reach and nhi + reach <= hi
    assert len(set(tiles[5::6])) == 1


@pytest.mark.parametrize("c_in,c_out,k_up", [(128, 64, 4), (64, 32, 4), (32, 16, 2), (128, 64, 8)],
                         ids=["c64", "c32", "c16", "c64-k8"])
def test_tail_stream_slabs_give_back_the_weights(c_in, c_out, k_up):
    """`tail_cuda.pack_stream`, read back by byte address: element W[k, n]
    of a slab sits at byte 32·n + 2·(k % 16) of it with bit 4 of the address
    XOR bit 7 (the 32-byte swizzle wgmma's descriptor names).  The
    upsample's taps come back in phase order (`phase_taps`), each as C_in/16
    slabs, then every MRF conv's dense taps as C/16 slabs each, exactly."""
    gen = torch.Generator().manual_seed(c_out + k_up)
    up = conv_transpose1d(c_in, c_out, k_up, 2)
    rbs = [ResBlock1(c_out, k, d) for k, d in zip(KS, DILS)]
    with torch.no_grad():
        for module in [up, *rbs]:
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
    packed = tail_cuda.pack_tail_weights(up, rbs)
    stream, n_slabs = packed["slabs"], tail_cuda.stream_slabs(c_in, c_out, k_up, KS, DILS)
    assert stream.shape == (n_slabs, c_out, 16) and stream.dtype == torch.bfloat16 and stream.is_contiguous()
    k = np.arange(16)[:, None]
    n = np.arange(c_out)[None, :]
    byte = 32 * n + 2 * k
    byte = byte ^ (((byte >> 7) & 1) << 4)
    dense = stream.view(torch.int16).reshape(n_slabs, c_out * 16)[:, torch.from_numpy(byte // 2)]
    dense = dense.view(torch.bfloat16)  # [n_slabs, 16, C]: slab s's B tile, K by N
    phases = tail_cuda.phase_taps(k_up, 2, packed["pad_up"])
    assert sorted(j for _, taps in phases for j in taps) == list(range(k_up))
    s = 0
    for _, taps in phases:
        for j in taps:
            got = dense[s:s + c_in // 16].reshape(c_in, c_out)
            assert torch.equal(got, up.weight.detach()[:, :, j].to(torch.bfloat16)), (j, s)
            s += c_in // 16
    for rb in rbs:
        for conv in (m for pair in zip(rb.convs1, rb.convs2) for m in pair):
            for j in range(conv.kernel_size[0]):
                got = dense[s:s + c_out // 16].reshape(c_out, c_out)
                assert torch.equal(got, conv.weight.detach()[:, :, j].t().to(torch.bfloat16)), (j, s)
                s += c_out // 16
    assert s == n_slabs
    assert tail_cuda.pack_stream(packed["up_w"][:, :24], packed["w"], 2, packed["pad_up"]) is None


@pytest.mark.parametrize("c_in,c_out,k_up,last", [(128, 64, 8, False), (64, 32, 2, False), (32, 16, 2, True)],
                         ids=["stage2", "stage3", "stage4"])
@torch.inference_mode()
def test_tail_stage_plain_takes_melo_stages_as_the_stock_layers(c_in, c_out, k_up, last):
    """MeloTTS's decoder stages 2-4 (upsample kernels 8, 2, 2 at stride 2;
    128 → 64, 64 → 32 and 32 → 16 channels, the last with conv_post and
    tanh), which the V2 and V1 decoders never give K4: `tail_stage_plain`
    in f32 against the stock modules (`nn.hifigan.ResBlock1`, the
    transposed conv, conv_post) on a ragged batch, masked as the decoder
    masks, 1e-5 (f32 sums in another order)."""
    gen = torch.Generator().manual_seed(c_out + k_up)
    up = conv_transpose1d(c_in, c_out, k_up, 2)
    rbs = torch.nn.ModuleList(ResBlock1(c_out, k, d) for k, d in zip(KS, DILS))
    post = conv1d(c_out, 1, 7, bias=False) if last else None
    for module in (up, rbs, post):
        for p in (module.parameters() if module is not None else ()):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    packed = tail_cuda.pack_tail_weights(up, list(rbs), post, torch.float32)
    t_in, lengths_in = 300, torch.tensor([300, 187])
    x = torch.randn(2, t_in, c_in, generator=gen) * (torch.arange(t_in)[None, :, None] < lengths_in[:, None, None])
    out = tail_cuda.tail_stage(x.contiguous(), lengths_in * 2, packed)
    mask_in = (torch.arange(t_in)[None] < lengths_in[:, None]).float()[:, None]
    mask = torch.repeat_interleave(mask_in, 2, dim=2)
    y = up(F.leaky_relu(x.transpose(1, 2) * mask_in, 0.1)) * mask
    y = sum(rb(y, mask) for rb in rbs) / len(rbs)
    if last:
        y = torch.tanh(post(F.leaky_relu(y, 0.01)))
        out, y = out[..., 0], y[:, 0]
        for r, n in enumerate(lengths_in.tolist()):   # no mask follows conv_post: compare the true samples
            torch.testing.assert_close(out[r, : 2 * n], y[r, : 2 * n], atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out, y.transpose(1, 2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("last,len_out,live", [
    (False, 640, 5), (False, 641, 6), (False, 639, 5),
    (True, 640 - 3, 5), (True, 640 - 2, 6), (True, 640 + 1, 6), (True, 639 - 3, 5)],
    ids=["middle-at", "middle-past", "middle-before", "last-at", "last-reach", "last-past", "last-before"])
@torch.inference_mode()
def test_tail_tiles_past_the_length_are_zero(last, len_out, live):
    """The kernel's early exit: a tile whose first sample, less conv_post's
    reach on the last stage, lies at or past the length returns with its
    output set to 0.  The plain version gives exactly 0 on every such tile
    and not on the tile just before it, which `live_tiles` counts."""
    c_in, c_out, tile, t_in = (64, 32, 128, 500) if last else (128, 64, 128, 500)
    rng = np.random.default_rng(len_out)
    packed = _tail_packed(rng, c_in, c_out, last, torch.float32)
    x = torch.from_numpy((rng.standard_normal((1, t_in, c_in)) * 0.5).astype(np.float32))
    out = tail_cuda.tail_stage(x, torch.tensor([len_out]), packed)
    t_out = t_in * 2
    assert tail_cuda.live_tiles(len_out, tile, 3 if last else 0, t_out) == live
    for i in range(-(-t_out // tile)):
        block = out[0, i * tile:(i + 1) * tile]
        assert bool((block == 0).all()) == (i >= live), (i, live)


# -- the cluster kernels' weight streams ---------------------------------------

STREAM_RANKS = [1, 2, 4, 8]
STREAM_KINDS = ["wn", "coupling-fwd", "coupling-rev"]


@pytest.fixture(scope="module")
def stream_models():
    """A WaveNet and a flow at the shipped widths (H = C = 192, K = 5: 24
    column tiles, which every cluster size here splits evenly), with seeded
    weights; fewer layers than the shipped ones, which only lengthens the
    streams."""
    from openvoice_tpu_torch.nn.flows import ResidualCouplingBlock

    gen = torch.Generator().manual_seed(11)
    wn = WN(192, 5, 3, 0)
    flow = ResidualCouplingBlock(192, 192, 5, 2, 2, 0)
    with torch.no_grad():
        for p in list(wn.parameters()) + list(flow.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen))
    return wn, flow


def _stream_case(stream_models, kind, ranks):
    """(packed, products in execution order, (streams, units) of
    `_frag.cluster_streams` for `ranks` CTAs a cluster) of one kernel's
    direction."""
    wn, flow = stream_models
    if kind == "wn":
        packed = wn_cuda.stack_wn_params(wn)
        products = wn_cuda.wn_products(packed["w_in"], packed["w_rs"])
    else:
        packed = coupling_cuda.pack_coupling_block(flow, reverse=kind == "coupling-rev")
        products = coupling_cuda.coupling_products(packed)
    return packed, products, _frag.cluster_streams(products, ranks)


def _read_slabs(region: torch.Tensor, taps: int, k: int, n: int) -> torch.Tensor:
    """[taps, K, n] bfloat16 back from a run of `pack_slabs`'s slabs, each
    element W[k, n] read at the byte wgmma's descriptor reads it from: byte
    32·n + 2·(k % 16) of slab (tap, k // 16), bit 4 of the address XOR bit 7
    (the 32-byte swizzle)."""
    kk = np.arange(k)[:, None]
    nn = np.arange(n)[None, :]
    byte = 32 * nn + 2 * (kk % 16)
    byte = byte ^ (((byte >> 7) & 1) << 4)
    flat = region.view(torch.int16).reshape(taps, k // 16, n * 16)
    return flat[:, torch.from_numpy(kk // 16 + 0 * nn), torch.from_numpy(byte // 2)].view(torch.bfloat16)


def _walk_streams(made, products, ranks):
    """Each rank's stream read back product by product, in execution order,
    by the units `made` gives each product: for every product the number of
    times each element of its dense matrix was found (and where it was found,
    its value checked against the matrix), and for every rank the columns it
    held."""
    streams, units = made
    share = 24 // ranks
    unit = 16 * 8 * share  # elements
    assert streams.shape == (ranks, sum(units) * unit) and streams.dtype == torch.bfloat16
    counts = [torch.zeros(w.shape, dtype=torch.int32) for w, _, _ in products]
    held = [[] for _ in range(ranks)]
    for r in range(ranks):
        pos = 0
        for p, ((w, halves, n_tiles), n_units) in enumerate(zip(products, units)):
            taps, k, _ = w.shape
            bounds = _frag.cluster_bounds(n_tiles, ranks)
            cols = _frag.share_columns(halves, range(bounds[r], bounds[r + 1]))
            assert n_units == taps * (k // 16) * len(halves)
            region = streams[r, pos:pos + n_units * unit]
            got = _read_slabs(region, taps, k, len(cols))
            assert torch.equal(got, w[..., cols].to(torch.bfloat16)), f"rank {r}, product {p}"
            counts[p][..., cols] += 1
            held[r].append(cols)
            pos += n_units * unit
        assert pos == streams.shape[1], "a rank's stream holds more than its products"
    return counts, held


@pytest.mark.parametrize("ranks", STREAM_RANKS)
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_cluster_streams_place_every_weight_once(stream_models, kind, ranks):
    """Every element of every weight matrix of K1 and K2 (both directions)
    lies in exactly one slab of exactly one rank's stream, at the byte the
    swizzled wgmma descriptor reads it from; only the last layer's res half,
    which the packing fills with zeros and the kernel never computes, lies in
    none."""
    _, products, made = _stream_case(stream_models, kind, ranks)
    counts, _ = _walk_streams(made, products, ranks)
    for (w, halves, _), count in zip(products, counts):
        if halves == (192,):  # the last layer: skip half only
            assert bool((count[..., 192:] == 1).all())
            assert bool((count[..., :192] == 0).all()) and bool((w[..., :192] == 0).all())
        else:
            assert bool((count == 1).all())


@pytest.mark.parametrize("ranks", STREAM_RANKS)
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_cluster_streams_hold_each_rank_its_columns(stream_models, kind, ranks):
    """Each rank's stream holds exactly its planned columns of every product
    (`_frag.cluster_columns`: a gate pair's tanh and sigmoid columns, a
    channel's res and skip columns, with one owner), in execution order (the
    gate's K taps, res|skip, a layer; for K2 pre, the layers, post, a step,
    forward or reverse as `_exec_order` says), each 8-column tile of one
    half beside the same tile of the other."""
    packed, products, made = _stream_case(stream_models, kind, ranks)
    _, held = _walk_streams(made, products, ranks)
    n_layers = packed["w_in"].shape[-4]
    names = ["gate", "res|skip"] * n_layers
    if kind != "wn":
        names = (["pre"] + names + ["post"]) * packed["w_in"].shape[0]
    assert len(names) == len(products) == len(made[1]) == len(packed["stream_units"])
    for p, (name, (w, halves, _)) in enumerate(zip(names, products)):
        n_out = w.shape[-1]
        plan = _frag.cluster_columns(n_out, ranks, paired=name in ("gate", "res|skip"))
        for r in range(ranks):
            cols = held[r][p]
            want = plan[r] if halves != (192,) else [c for c in plan[r] if c >= 192]
            assert sorted(cols) == sorted(want), f"{name}: rank {r} holds other columns"
            if len(halves) == 2:
                tiles = [cols[i:i + 8] for i in range(0, len(cols), 8)]
                assert all(b[0] == a[0] + 192 for a, b in zip(tiles[::2], tiles[1::2])), f"{name}: halves apart"
    if kind != "wn":
        ref = coupling_cuda.pack_coupling_block(stream_models[1], reverse=kind == "coupling-rev")
        for s in range(packed["wp"].shape[0]):
            assert torch.equal(products[s * (2 * n_layers + 2)][0][0], ref["wp"][s])
            assert torch.equal(products[(s + 1) * (2 * n_layers + 2) - 1][0][0], ref["wq"][s])


class _ClusterSmemStandIn:
    """K1's and K2's shared memory, as ``csrc/wn.cu::wn_stack_smem_bytes``
    and ``csrc/coupling.cu::coupling_smem_bytes`` compute it (alignment room,
    the ring's units and two barriers a group, then the window, held chunk by
    chunk with 9 pad rows a chunk, and the f32 skip sum), so that
    `cluster_plan` runs without the card."""

    @staticmethod
    def wn(hidden, rows, tile, skip_cols, unit_bytes, ring_units, stages):
        return 256 + ring_units * unit_bytes + 16 * max(stages, 1) + 2 * 2 * hidden * (rows + 9) + tile * skip_cols * 4

    @staticmethod
    def coupling(chan, hidden, rows, skip_cols, unit_bytes, ring_units, stages):
        return (256 + ring_units * unit_bytes + 16 * max(stages, 1) + 2 * (chan + 2 * hidden) * (rows + 9)
                + rows * skip_cols * 4)


@pytest.mark.parametrize("t_len", [1024, 333, 40], ids=["bucket1024", "ragged333", "short"])
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_cluster_ring_plan_covers_each_stream_once(monkeypatch, stream_models, kind, t_len):
    """The ring plan of a K1 or K2 launch walks each rank's stream once:
    copied group by group as the device copies them
    (csrc/ring.cuh::ring_copy), the groups are the stream's units in order,
    each unit once; the items are the built instance's (CLUSTER_WIDTH
    columns of a wide product), and every product is one round of them (the
    window's 64-row tiles times the parts of the CTA's columns, at most the
    warpgroups); and the window and ring fit in shared memory."""
    monkeypatch.setattr(_frag, "_CLUSTER_PLANS", {})
    monkeypatch.setattr(_frag, "_WINDOWS", {})
    module = wn_cuda if kind == "wn" else coupling_cuda
    packed, products, _ = _stream_case(stream_models, kind, _frag.CLUSTER_RANKS)
    n_steps = 1 if kind == "wn" else packed["w_in"].shape[0]
    halo = n_steps * packed["w_in"].shape[-4] * 2
    share = 24 // _frag.CLUSTER_RANKS
    assert packed["streams"].shape[0] == _frag.CLUSTER_RANKS
    assert _frag.check_streams(packed, len(products), packed["streams"].device) == share
    if kind == "wn":
        smem = lambda r, tl, ub, n, s: _ClusterSmemStandIn.wn(192, r, tl, 8 * share, ub, n, s)
    else:
        smem = lambda r, tl, ub, n, s: _ClusterSmemStandIn.coupling(192, 192, r, 8 * share, ub, n, s)
    launch = _frag.cluster_plan((kind, 192), halo, t_len, packed["stream_units"], share, smem, module._MAX_STAGES)
    assert launch["smem"] <= _frag.SMEM_MAX and launch["stages"] >= 1
    assert launch["rows"] % 64 == 0 and launch["rows"] - launch["tile"] == 2 * halo
    count, group = launch["rows"] // 64, launch["group"]
    assert _frag.CLUSTER_WIDTH * launch["parts"] == 16 * share, "items of the built instance's width"
    assert count * launch["parts"] <= _frag.CLUSTER_WARPGROUPS, "a product is one round"
    with pytest.raises(ValueError, match="do not split"):
        _frag.cluster_plan((kind, 128), halo, t_len, packed["stream_units"], 4, smem, module._MAX_STAGES)
    entries = [tuple(e) for e in np.asarray(list(launch["plan"])).reshape(-1, 5)]
    assert [e[2] for e in entries] == list(packed["stream_units"])
    copied = []
    for p in range(entries[-1][4]):
        e = next(i for i, entry in enumerate(entries) if p < entry[4])
        first, _, steps, slab0, _ = entries[e]
        start = entries[e - 1][4] if e else 0
        q = (p - start) % -(-steps // group)
        n = min(group, steps - q * group)
        copied += range(slab0 + q * group, slab0 + q * group + n)
        assert first == 0
    assert copied == list(range(sum(packed["stream_units"])))
