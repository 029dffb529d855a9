"""Acoustic model milliseconds per request: the window's forwards of
``infer.model`` (forward hooks, each edge synchronized), over the requests
they served (the batch size each)."""


def read(ctx):
    spans = ctx["spans"]
    if not spans.calls.get("acoustic"):
        return None
    return 1e3 * spans.total["acoustic"] / (spans.calls["acoustic"]
                                            * ctx["batch"])
