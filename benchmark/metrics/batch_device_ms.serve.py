"""batch_device_ms.serve: the card's ms a served batch: the sum of the
``ShapeGraphs.timer`` spans over the batches in the window."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("spans_ms"):
        return None
    return sum(rec["spans_ms"]) / rec["units"]
