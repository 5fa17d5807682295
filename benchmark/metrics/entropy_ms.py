"""entropy_ms: the host's ms of the entropy decode a batch on the card's
decode route (``GpuJpegDecoder.times``' ``host_ms``, the worker threads'
span), summed over the batches decoded in the window over their number."""


def read(rec):
    ms = rec.get("entropy_ms")
    if rec.get("kind") != "loader" or not ms:
        return None
    return sum(ms) / len(ms)
