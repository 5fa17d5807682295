"""serve_img_s: every image served in the window over the window's
seconds, from the first batch's hand-off to the host's fetch of the last
one's results."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return rec["images"] / rec["window_s"]
