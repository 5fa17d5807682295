"""idle.train: the share of the training window in which the card ran no
dispatch: 1 - the sum of the CUDA-event spans around each dispatch (its
superbatch copy and its graph's replay) over the window's seconds, in %."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("spans_ms"):
        return None
    return 100.0 * (1.0 - sum(rec["spans_ms"]) / 1e3 / rec["window_s"])
