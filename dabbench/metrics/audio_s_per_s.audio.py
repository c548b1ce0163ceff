"""Host seconds the audio worker processes spent decoding (the pool's
``decode_seconds``, ``Metrics.audio_decode_seconds``) a second of signal
staged in the window."""

UNIT = "s/signal-s"


def read(ctx):
    s = ctx.counters.get("audio_decode_seconds")
    if not s or not ctx.signal_s:
        return None
    return s / ctx.signal_s
