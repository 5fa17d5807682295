"""setup_s: seconds from the start of the run's process to the end of the
driver's set-up (imports, CUDA, kernel builds, weights, inputs, captures)."""


def read(rec):
    return rec.get("setup_s")
