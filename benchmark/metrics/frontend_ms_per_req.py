"""Reference front-end milliseconds per request: the window's calls of the
instance's ``preprocess_input`` (log-mel, F0, both d-vectors), each
between two device synchronizes, over the requests."""


def read(ctx):
    spans = ctx["spans"]
    if not spans.calls.get("frontend"):
        return None
    return 1e3 * spans.total["frontend"] / spans.calls["frontend"]
