"""train_img_s: every image trained in the window over the window's
seconds, from the first dispatch's enqueue to the host's fetch of the
last one's loss."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    return rec["images"] / rec["window_s"]
