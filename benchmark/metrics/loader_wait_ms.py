"""loader_wait_ms: the host's ms a step waiting for the loader's next
batch (its clock around each ``next()``), summed over the window over
its steps."""


def read(rec):
    if rec.get("kind") != "loader" or not rec.get("waits_ms"):
        return None
    return sum(rec["waits_ms"]) / rec["steps"]
