"""MeloTTS-English on the port's TTS path against the benchmark's plain
reference (``ovbench/reference/melo.py``), on the CPU at a small size with
seeded random weights: BERT, the text side's tokens, the text encoder, the
transformer-coupling flow, `tts_batched` and `tts` in both modes, padding,
the Melo config loader and the checkpoint layout.

The model is MeloTTS's architecture at small widths (hidden 32, BERT 2 × 64)
with its five decoder stages routed as the full model's are: stages 0-1 to
K3's plain version behind a stock upsample, stages 2-3 to K4's with upsample
kernels 8 and 2, stage 4 to K4's with conv_post at 16 channels.  Every
weight is drawn uniform in ±1/√fan_in (the flow's ``post`` and the spline
flows' ``proj`` included, which MeloTTS initialises to zero: a zero ``post``
makes the flow the identity and keeps its attention from the audio).

Durations are ceilings: comparisons of audio feed both sides ceilings that
are checked equal first."""

import copy
import json
import math

import numpy as np
import pytest
import torch
from torch import nn

from openvoice_tpu_torch.api import BaseSpeakerTTS, _stack_enc_rows
from openvoice_tpu_torch.ckpt.torch_import import load_torch_checkpoint
from openvoice_tpu_torch.config import HParams, MeloTTSConfig, melo_tts_en_config
from openvoice_tpu_torch.models import synthesizer as TS
from openvoice_tpu_torch.nn.bert import Bert, BertConfig, load_bert_state_dict
from openvoice_tpu_torch.nn.extras import TransformerCouplingBlock
from openvoice_tpu_torch.runtime.profiler import METRICS
from openvoice_tpu_torch.text import melo as tmelo
from ovbench.reference import melo as RM
from ovbench.reference import model as R

TINY_MELO = dict(
    n_vocab=40, n_speakers=6, zero_g=False, spec_channels=65, filter_length=128, hop_length=32, win_length=128,
    inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=3, kernel_size=3,
    upsample_initial_channel=512, upsample_rates=(2, 2, 2, 2, 2), upsample_kernel_sizes=(4, 4, 8, 2, 2),
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)), gin_channels=32, enc_q_layers=2,
    sampling_rate=16000, num_tones=16, num_languages=10, bert_channels=1024, ja_bert_channels=64,
    n_layers_trans_flow=3, flow_n_flows=2,
)
TINY_BERT = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128, max_position_embeddings=128,
                 num_layers=2)
TEXT = ("Four score and seven years ago our fathers brought forth on this continent a new nation. "
        "It is rather for us to be here dedicated to the great task remaining before us.")
SPEAKER = 3
CONV_POST_GAIN = 4.0   # audio well above the bounds' floors, as the benchmark's weights
# f32 throughout: the CPU's products sum in another order at another shape
# (a padded bucket, a batch of two) and round the last bits differently;
# errors below are relative to the audio's peak.  bf16 anywhere in the f32
# path errs by 2^-9 relative or more (the ratio test below holds that).
F32_BAR = 2e-5
STAGES = ("mrf0", "mrf1", "upmrf2", "upmrf3", "tail")


def _uniform(module: nn.Module, gen: torch.Generator) -> None:
    """Every tensor but the LayerNorms' uniform in ±1/√fan_in, fan_in that
    of its layer's weight over the weight's first axis (an embedding's rows:
    its width)."""
    with torch.no_grad():
        for mod in module.modules():
            if type(mod).__name__ == "LayerNorm":
                continue
            w = getattr(mod, "weight", None)
            for p in mod.parameters(recurse=False):
                ref = w if isinstance(w, torch.Tensor) and w.dim() > 1 else p
                fan = ref.shape[-1] if isinstance(mod, nn.Embedding) else max(ref[0].numel(), 1)
                s = 1.0 / math.sqrt(fan)
                p.uniform_(-s, s, generator=gen)


@pytest.fixture(scope="module")
def melo():
    """(port TTS in f32 on the CPU, reference model, reference BERT)."""
    cfg = MeloTTSConfig(**TINY_MELO)
    gen = torch.Generator().manual_seed(5)
    model = TS.init_synthesizer(cfg, gen)
    _uniform(model, gen)
    with torch.no_grad():
        model.dec.conv_post.weight.mul_(CONV_POST_GAIN)
        model.emb_g.weight.normal_(0.0, 1.0, generator=gen)
    bert = Bert(BertConfig(**TINY_BERT))
    _uniform(bert, gen)
    tts = BaseSpeakerTTS(cfg=cfg, device="cpu", bert_cfg=BertConfig(**TINY_BERT))
    tts.set_model(model)
    tts.set_bert(bert)
    rcfg = RM.MeloConfig.from_dict(TINY_MELO)
    ref = RM.Synthesizer(rcfg)
    ref.load_state_dict(model.state_dict(), strict=True)
    rbert = RM.Bert(RM.BertConfig.from_dict(TINY_BERT))
    rbert.load_state_dict(bert.state_dict(), strict=True)
    return tts, ref.eval(), rbert.eval()


def _rngs(seed: int, n: int):
    out = []
    for child in np.random.SeedSequence(seed).spawn(n):
        w_ss, y_ss = child.spawn(2)
        out.append((np.random.default_rng(w_ss), np.random.default_rng(y_ss)))
    return out


@torch.no_grad()
def reference_tts(ref, rbert, text: str, sid: int, seed: int, stage: str | None = None,
                  ceilings: list | None = None) -> tuple[np.ndarray, list]:
    """The reference's answer to `tts_batched(text, sid, seed)`: each piece
    at its true length, 0.05 s gaps; `stage` "bf16" stores the flow's and
    the decoder's values in bf16 (the serving mode's twin).  Returns (audio,
    each piece's ceilings)."""
    pieces = RM.split_pieces(text)
    toks = [RM.melo_tokens(p, ref.cfg.n_vocab, rbert.cfg.vocab_size) for p in pieces]
    gap = np.zeros(int(ref.cfg.sampling_rate * 0.05), np.float32)
    out, ceils = [], []
    if stage is not None:  # `R.stored` rounds the weights in place: a copy of its own
        ref = copy.deepcopy(ref)
    with R.precision("f32"):
        for k, (tk, (rng_w, rng_y)) in enumerate(zip(toks, _rngs(seed, len(toks)))):
            noise_w = torch.from_numpy(rng_w.standard_normal((len(tk.phones), 2)).astype(np.float32))
            m_p, logs_p, w, g = RM.tts_durations(ref, rbert, tk, sid, noise_w)
            w_ceil = torch.ceil(w) if ceilings is None else ceilings[k]
            ceils.append(w_ceil)
            t_y = max(int(w_ceil.sum()), 1)
            noise = torch.from_numpy(rng_y.standard_normal((t_y, ref.cfg.inter_channels)).astype(np.float32))
            z_p = R.tts_latents(m_p, logs_p, w_ceil, noise, noise_scale=0.6)
            with R.stored(stage, [ref.flow, ref.dec]):
                out += [R.np_audio(R.tts_decode(ref, z_p, g)), gap]
    return np.concatenate(out), ceils


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- the text side and BERT --------------------------------------------------------

@pytest.mark.parametrize("text", [TEXT, "Yes.", "Now we are engaged in a great civil war, testing whether that "
                                  "nation, or any nation so conceived and so dedicated, can long endure!"])
def test_tokens_match_the_reference_copy(text):
    """The port's text side and the reference's own copy agree id for id;
    word2ph covers every phone and the wordpieces open with [CLS] and close
    with [SEP]."""
    ours = [tmelo.english_tokens(p, 219, 30522) for p in tmelo.split_pieces(text)]
    theirs = [RM.melo_tokens(p, 219, 30522) for p in RM.split_pieces(text)]
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        for field in a._fields:
            assert getattr(a, field).tolist() == list(getattr(b, field)), field
        assert int(a.word2ph.sum()) == len(a.phones) and a.wordpieces[0] == 101 and a.wordpieces[-1] == 102
        assert len(a.phones) % 2 == 1 and not a.phones[::2].any() and not a.languages[::2].any()


def test_split_keeps_a_line_whole_and_splits_a_long_text():
    assert len(tmelo.split_pieces(TEXT)) == 1
    long = " ".join([TEXT] * 5)
    pieces = tmelo.split_pieces(long)
    assert len(pieces) > 1 and all(len(p) <= 512 for p in pieces)
    assert pieces == RM.split_pieces(long)


@pytest.mark.parametrize("padded", [False, True], ids=["alone", "padded-batch"])
@torch.no_grad()
def test_bert_matches_the_reference(melo, padded):
    """The port's BERT against the reference's, row by row at the true
    length; a padded batch of two rows gives each row what it gives alone
    (its padded keys weigh exactly 0).  f32: 1e-5 of the features' scale."""
    tts, _, rbert = melo
    rows = [[101, 2000, 2500, 3999, 102], [101, 7777, 102]]
    width = 8 if padded else None
    for r, ids in enumerate(rows):
        ref = RM.bert_features(rbert, ids, "cpu")
        if padded:
            batch = torch.zeros(2, width, dtype=torch.long)
            for j, row in enumerate(rows):
                batch[j, : len(row)] = torch.tensor(row)
            got = tts.bert(batch, torch.tensor([len(x) for x in rows]))[r, : len(ids)]
        else:
            got = tts.bert(torch.tensor([ids]), torch.tensor([len(ids)]))[0]
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@torch.no_grad()
def test_text_encoder_and_durations_match_the_reference(melo):
    """tones, languages, each phone's BERT feature and the speaker into the
    text encoder, then both duration predictors, in a padded token bucket:
    m_p, logs_p and the durations before the ceiling at 1e-5 (f32), and the
    ceilings exactly."""
    tts, ref, rbert = melo
    model = tts.model
    tk = tmelo.english_tokens(TEXT, TINY_MELO["n_vocab"], 30522)
    t_x, tb = len(tk.phones), 256
    noise_w = np.random.default_rng(1).standard_normal((tb, 2)).astype(np.float32)
    m_p, logs_p, w, g = RM.tts_durations(ref, rbert, RM.melo_tokens(TEXT, TINY_MELO["n_vocab"], 30522), SPEAKER,
                                         torch.from_numpy(noise_w[:t_x]))

    def pad(a, dtype=torch.long):
        out = torch.zeros(1, tb, dtype=dtype)
        out[0, : len(a)] = torch.as_tensor(a, dtype=dtype)
        return out

    feats = tts.bert(torch.tensor(tk.wordpieces[None].astype(np.int64)), torch.tensor([len(tk.wordpieces)]))
    ja_bert = feats[:, torch.from_numpy(tmelo.phone_word_index(tk.word2ph, tb))]
    gp = model.emb_g(torch.tensor([SPEAKER]))[:, None]
    h, mp, lp, x_mask = TS.text_encode(model, pad(tk.phones), torch.tensor([t_x]), pad(tk.tones), pad(tk.languages),
                                       ja_bert, gp)
    torch.testing.assert_close(mp[0, :t_x], m_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(lp[0, :t_x], logs_p, atol=1e-5, rtol=0)
    logw = TS.log_durations(model, h, x_mask, gp, torch.from_numpy(noise_w[None]), 0.8, 0.2)
    torch.testing.assert_close(torch.exp(logw[0, :t_x, 0]), w, atol=1e-5, rtol=1e-5)
    enc = TS.tts_encode(model, pad(tk.phones), torch.tensor([t_x]), torch.tensor([SPEAKER]),
                        torch.from_numpy(noise_w[None]), 0.8, tones=pad(tk.tones), languages=pad(tk.languages),
                        ja_bert=ja_bert)
    assert torch.equal(enc.w_ceil[0, :t_x], torch.ceil(w)) and not enc.w_ceil[0, t_x:].any()


# -- the transformer-coupling flow -------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@torch.no_grad()
def test_transformer_flow_matches_the_reference(melo, reverse):
    """The port's TransformerCouplingBlock (non-zero ``post``) against the
    reference's, padded to a longer bucket: the true frames at 1e-5 (f32)."""
    tts, ref, _ = melo
    gen = torch.Generator().manual_seed(9)
    n, bucket = 37, 64
    x = torch.randn(1, TINY_MELO["inter_channels"], bucket, generator=gen)
    g = torch.randn(1, TINY_MELO["gin_channels"], 1, generator=gen)
    mask = (torch.arange(bucket) < n).float()[None, None]
    assert isinstance(tts.model.flow, TransformerCouplingBlock)
    assert all(float(f.post.weight.abs().max()) > 0 for f in tts.model.flow.flows[::2])
    got = tts.model.flow(x * mask, mask, g=g, reverse=reverse)[..., :n]
    want = ref.flow(x[..., :n], torch.ones(1, 1, n), g=g, reverse=reverse)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert float((got - x[..., :n]).abs().max()) > 1e-2, "the flow moved nothing"


@torch.no_grad()
def test_transformer_flow_reverse_undoes_forward(melo):
    """reverse ∘ forward is the identity (mean-only couplings), to f32
    rounding; padded frames stay 0 in the coupled halves."""
    tts, _, _ = melo
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(2, TINY_MELO["inter_channels"], 48, generator=gen)
    mask = (torch.arange(48)[None] < torch.tensor([[48], [30]])).float()[:, None]
    g = torch.randn(2, TINY_MELO["gin_channels"], 1, generator=gen)
    y = tts.model.flow(x * mask, mask, g=g)
    back = tts.model.flow(y, mask, g=g, reverse=True)
    torch.testing.assert_close(back * mask, x * mask, atol=1e-5, rtol=0)


# -- the whole path ----------------------------------------------------------------

def test_tts_batched_f32_matches_the_reference(melo):
    """tts_batched(fast=False): BERT, encode, durations, length regulation,
    the flow in reverse and the five-stage decoder in f32, against the
    reference's true-length pass: F32_BAR of the peak."""
    tts, ref, rbert = melo
    out = tts.tts_batched(TEXT, None, SPEAKER, seed=11)
    want, _ = reference_tts(ref, rbert, TEXT, SPEAKER, seed=11)
    assert out.shape == want.shape and float(np.abs(want).max()) > 1e-2
    assert _rel(out, want) <= F32_BAR


def test_fast_strays_no_more_than_three_times_an_honest_bf16_pass(melo):
    """tts_batched(fast=True) decodes in bf16 (the flow on stock bf16 layers,
    stages 0-1 through K3's and 2-4 through K4's plain versions).  Its
    distance from f32 is held to three times that of the reference's bf16
    twin (each value stored in bf16), the benchmark's limit; and the f32
    bar above is tight enough to refuse either."""
    tts, ref, rbert = melo
    f32 = tts.tts_batched(TEXT, None, SPEAKER, seed=12)
    fast = tts.tts_batched(TEXT, None, SPEAKER, seed=12, fast=True)
    want, ceils = reference_tts(ref, rbert, TEXT, SPEAKER, seed=12)
    twin, _ = reference_tts(ref, rbert, TEXT, SPEAKER, seed=12, stage="bf16", ceilings=ceils)
    assert fast.shape == f32.shape == want.shape and np.isfinite(fast).all()
    assert tts._dec_cache["dtype"] == torch.bfloat16 and "flow" in tts._dec_cache
    assert all(k in tts._dec_cache for k in STAGES)
    honest = np.linalg.norm(twin - want) / np.linalg.norm(want)
    ours = np.linalg.norm(fast - want) / np.linalg.norm(want)
    assert 0 < ours <= 3 * honest, f"fast {ours:.3e} against the bf16 twin's {honest:.3e}"
    assert _rel(fast, want) > F32_BAR and _rel(twin, want) > F32_BAR


@pytest.mark.parametrize("part", ["bert", "flow", "dec"])
def test_f32_bar_refuses_bf16_in_any_part(melo, monkeypatch, part):
    """The f32 bar is tight: the reference with one part's values stored in
    bf16 (BERT, the flow, the decoder; the same ceilings) strays past it."""
    _, ref, rbert = melo
    want, ceils = reference_tts(ref, rbert, TEXT, SPEAKER, seed=11)
    ref, rbert = copy.deepcopy(ref), copy.deepcopy(rbert)
    if part == "bert":
        real = RM.bert_features
        monkeypatch.setattr(RM, "bert_features", lambda b, w, d: _in_bf16(b, real, b, w, d))
    else:
        module = getattr(ref, part)
        real = module.forward
        monkeypatch.setattr(module, "forward", lambda *a, **k: _in_bf16(module, real, *a, **k))
    got, _ = reference_tts(ref, rbert, TEXT, SPEAKER, seed=11, ceilings=ceils)
    assert _rel(got, want) > F32_BAR


def _in_bf16(module, fn, *args, **kwargs):
    with R.stored("bf16", [module]):
        return fn(*args, **kwargs)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_tts_equals_tts_batched(melo, fast):
    """Sentence by sentence and batched give the same audio for one seed
    (two pieces: the second in another frame bucket)."""
    tts, _, _ = melo
    text = " ".join([TEXT] * 4)
    assert len(tts._sentence_tokens(text, SPEAKER, "English")[0]) >= 2
    a = tts.tts(text, None, SPEAKER, seed=13, fast=fast)
    b = tts.tts_batched(text, None, SPEAKER, seed=13, fast=fast)
    assert a.shape == b.shape
    # bf16: the flow's stock layers run at another batch and bucket, sum in
    # another order and may flip a bf16 rounding, which the decoder carries
    # on (the V1 TTS's bar for the same comparison)
    bar = 1e-6 if not fast else 2.0 ** -6 * float(np.abs(a).max())
    np.testing.assert_allclose(a, b, atol=bar)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@torch.no_grad()
def test_padded_bucket_decodes_as_the_true_length(melo, dtype):
    """A row decoded in a frame bucket twice its length, and beside a
    shorter row in a group of two, gives the audio of its true-length
    decode: the flow's attention masks the padded frames as the encoder's
    does, the kernels' plain versions rebuild their masks from the lengths.
    f32: the CPU's sums over padded zeros round alike (1e-5 of the peak).
    bf16: a stock bf16 layer at another shape sums in another order and
    flips roundings, which the flow and decoder carry on, so the padded row
    lies as far from the true-length one as two honest bf16 passes may: at
    most twice the true-length bf16 pass's distance from its f32 pass (L2)."""
    tts, _, _ = melo
    model = tts.model
    cache, cache32 = TS.make_dec_cache(model, dtype), TS.make_dec_cache(model, torch.float32)
    fast = dtype == torch.bfloat16
    tk = [tmelo.english_tokens(s, TINY_MELO["n_vocab"], 30522) for s in (TEXT, "A new nation, conceived in liberty.")]
    rows = []
    for k, t in enumerate(tk):
        tb = 256
        noise_w = torch.from_numpy(np.random.default_rng(20 + k).standard_normal((1, tb, 2)).astype(np.float32))
        pad = lambda a: torch.nn.functional.pad(torch.as_tensor(a, dtype=torch.long), (0, tb - len(a)))[None]
        feats = tts.bert(torch.tensor(t.wordpieces[None].astype(np.int64)), torch.tensor([len(t.wordpieces)]))
        enc = TS.tts_encode(model, pad(t.phones), torch.tensor([len(t.phones)]), torch.tensor([SPEAKER]), noise_w,
                            0.8, tones=pad(t.tones), languages=pad(t.languages),
                            ja_bert=feats[:, torch.from_numpy(tmelo.phone_word_index(t.word2ph, tb))])
        rows.append({k_: getattr(enc, k_)[0] for k_ in ("m_p", "logs_p", "x_mask", "w_ceil")})
    frames = [int(r["w_ceil"].sum()) for r in rows]
    g_row = model.emb_g.weight[SPEAKER][None]
    noise = torch.from_numpy(np.random.default_rng(30).standard_normal((2, 2 * max(frames), 32)).astype(np.float32))
    both, _ = TS.tts_decode(model, _stack_enc_rows(rows, [0, 1], g_row), 2 * max(frames), noise, 0.6, fast=fast,
                            dec_cache=cache)
    up = 32
    for r in range(2):
        enc_r = _stack_enc_rows(rows, [r], g_row)
        alone, _ = TS.tts_decode(model, enc_r, frames[r], noise[r:r + 1, : frames[r]], 0.6, fast=fast, dec_cache=cache)
        n = frames[r] * up
        got, want = both[r, :n, 0].float().numpy(), alone[0, :n, 0].float().numpy()
        if fast:
            f32, _ = TS.tts_decode(model, enc_r, frames[r], noise[r:r + 1, : frames[r]], 0.6, dec_cache=cache32)
            honest = np.linalg.norm(want - f32[0, :n, 0].numpy())
            assert honest > 0 and np.linalg.norm(got - want) <= 2 * honest
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()))
        assert bool((both[r, n + 3:] == 0).all()), "audio past the length (and conv_post's reach) must be 0"


def test_counters_count_true_and_decoded_frames(melo):
    """tts_batched raises tts_true_frames by its rows' frames and
    tts_decoded_frames by rows × frame bucket, once a group."""
    tts, _, _ = melo
    before = dict(METRICS.snapshot()["counters"])
    out = tts.tts_batched(TEXT, None, SPEAKER, seed=14)
    after = METRICS.snapshot()["counters"]
    true = after["tts_true_frames"] - before.get("tts_true_frames", 0.0)
    decoded = after["tts_decoded_frames"] - before.get("tts_decoded_frames", 0.0)
    gap = int(TINY_MELO["sampling_rate"] * 0.05)
    assert true == (len(out) - gap) // 32 and decoded >= true and decoded in (64, 128, 192, 256, 384, 512, 768)


# -- the configuration and the checkpoint layout -------------------------------------

def _melo_config_json(cfg: MeloTTSConfig) -> dict:
    """A config.json in MeloTTS's layout (MeloTTS-English's, at cfg's widths)."""
    model = {k: getattr(cfg, k) for k in ("inter_channels", "hidden_channels", "filter_channels", "n_heads",
                                          "n_layers", "kernel_size", "p_dropout", "resblock",
                                          "upsample_initial_channel", "gin_channels")}
    model.update(resblock_kernel_sizes=list(cfg.resblock_kernel_sizes),
                 resblock_dilation_sizes=[list(d) for d in cfg.resblock_dilation_sizes],
                 upsample_rates=list(cfg.upsample_rates), upsample_kernel_sizes=list(cfg.upsample_kernel_sizes),
                 n_layers_trans_flow=cfg.n_layers_trans_flow, n_layers_q=3, use_spectral_norm=False,
                 use_spk_conditioned_encoder=True, use_noise_scaled_mas=True, use_mel_posterior_encoder=False,
                 use_duration_discriminator=True)
    data = {"sampling_rate": cfg.sampling_rate, "filter_length": cfg.filter_length, "hop_length": cfg.hop_length,
            "win_length": cfg.win_length, "n_mel_channels": 128, "add_blank": True, "n_speakers": cfg.n_speakers,
            "spk2id": {"EN-US": 0, "EN-BR": 1, "EN_INDIA": 2, "EN-AU": 3, "EN-Default": 4}}
    return {"data": data, "model": model, "num_languages": cfg.num_languages, "num_tones": cfg.num_tones,
            "symbols": [f"s{i}" for i in range(cfg.n_vocab)]}


def test_melo_config_json_gives_the_preset(tmp_path):
    """MeloTTS-English's config.json layout → the preset, and a
    BaseSpeakerTTS built from it reads speaker names through spk2id."""
    preset = melo_tts_en_config()
    got = MeloTTSConfig.from_hparams(HParams(**_melo_config_json(preset)))
    assert got == preset
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_melo_config_json(preset)))
    tts = BaseSpeakerTTS(str(path), device="cpu")   # no weights yet: nothing of full size is built
    assert tts.cfg == preset and tts.bert_cfg == BertConfig()
    assert (tts.noise_scale, tts.noise_scale_w) == (0.6, 0.8)
    assert tts._sentence_tokens("Yes.", "EN-AU", "English")[1] == 3
    assert tts._sentence_tokens("Yes.", 4, "English")[1] == 4


@pytest.mark.parametrize("key", ["use_transformer_flow", "use_spk_conditioned_encoder"])
def test_melo_config_json_without_melo_layers_is_refused(key):
    """Every published MeloTTS config builds the transformer flow and the
    speaker-conditioned encoder, the only ones the port builds; a config
    that turns either off is refused, not run as something else."""
    hps = _melo_config_json(melo_tts_en_config())
    hps["model"][key] = False
    with pytest.raises(ValueError, match=key):
        MeloTTSConfig.from_hparams(HParams(**hps))


def test_melo_checkpoint_loads_strictly(melo, tmp_path):
    """A state dict in MeloTTS's key layout, written by the reference,
    loads through ckpt/torch_import.py with no key missing or left over and
    every tensor where the reference put it."""
    _, ref, _ = melo
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    path = tmp_path / "checkpoint.pth"
    torch.save({"model": sd, "iteration": 7}, path)
    model, report = load_torch_checkpoint(str(path), MeloTTSConfig(**TINY_MELO))
    assert report == {"missing": [], "unexpected": []}
    got = model.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)


def test_bert_checkpoint_layout_loads(melo):
    """A Hugging Face BertForPreTraining-style state dict (``bert.`` prefix,
    two more layers, pooler, heads) loads into the layers MeloTTS reads."""
    tts, _, _ = melo
    full = BertConfig(**{**TINY_BERT, "num_layers": 4})
    sd = {f"bert.{k}": v for k, v in Bert(full).state_dict().items()}
    sd.update({"bert.pooler.dense.weight": torch.zeros(64, 64), "cls.predictions.bias": torch.zeros(30522),
               "bert.embeddings.position_ids": torch.arange(128)[None]})
    bert = load_bert_state_dict(sd, BertConfig(**TINY_BERT))
    assert len(bert.encoder.layer) == 2
    assert torch.equal(bert.encoder.layer[1].output.dense.weight, sd["bert.encoder.layer.1.output.dense.weight"])
