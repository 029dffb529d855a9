"""Vocoder milliseconds per second of audio returned: the window's
generator forwards, each between two device synchronizes, over the audio
that the window's requests returned."""


def read(ctx):
    spans = ctx["spans"]
    if not spans.calls.get("vocoder") or not ctx["audio_s"]:
        return None
    return 1e3 * spans.total["vocoder"] / ctx["audio_s"]
