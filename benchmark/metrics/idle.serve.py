"""idle.serve: the share of the serving window in which the card ran no
batch: 1 - the sum of the ``ShapeGraphs.timer`` spans (each batch's
copies in and replay) over the window's seconds, in %."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("spans_ms"):
        return None
    return 100.0 * (1.0 - sum(rec["spans_ms"]) / 1e3 / rec["window_s"])
