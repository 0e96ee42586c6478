"""Share of the TTS decode groups' frames that are padding: one minus the
window's rise of ``METRICS`` ``tts_true_frames`` (the rows' own frames) over
that of ``tts_decoded_frames`` (rows × frame bucket of each decode group;
api.py ``BaseSpeakerTTS.tts`` / ``tts_batched``).  The flow's attention
costs a padded row bucket² a layer, so padding shows in the latency.  A
program without these counters reads nothing."""


def read(ctx) -> float | None:
    counters = ctx.counters or {}
    if not counters.get("tts_decoded_frames") or "tts_true_frames" not in counters:
        return None
    return 100.0 * (1.0 - counters["tts_true_frames"] / counters["tts_decoded_frames"])
