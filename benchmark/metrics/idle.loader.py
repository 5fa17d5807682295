"""idle.loader: the share of the loader-fed window in which the card ran
no dispatch: 1 - the sum of the CUDA-event spans around each dispatch
(from once the host holds its batch) over the window's seconds, in %."""


def read(rec):
    if rec.get("kind") != "loader" or not rec.get("spans_ms"):
        return None
    return 100.0 * (1.0 - sum(rec["spans_ms"]) / 1e3 / rec["window_s"])
