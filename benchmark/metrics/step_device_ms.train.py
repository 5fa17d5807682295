"""step_device_ms.train: the card's ms a train step: the sum of the
CUDA-event spans around each dispatch over the steps in the window."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("spans_ms"):
        return None
    return sum(rec["spans_ms"]) / rec["steps"]
