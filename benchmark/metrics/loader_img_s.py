"""loader_img_s: every image trained in the loader-fed window over the
window's seconds, from the first batch's request to the host's fetch of
the last step's loss (the waits for the loader included)."""


def read(rec):
    if rec.get("kind") != "loader":
        return None
    return rec["images"] / rec["window_s"]
