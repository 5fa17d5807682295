"""Decode-only host loader — the port's own copy of
``posetpu/data/loader.py`` (``load_sample``, ``pad_batch``,
``group_stack``, ``threaded_place_iter``, ``HostLoader``), with a CUDA
batch placer.

The host does the one thing the device does not: variable-size JPEG
decode.  Warp, jitter and targets run on the device
(:mod:`posetpu_torch.aug.pipeline`).  Batches are padded to one static
shape.  Oversized images are integer-cropped (a pure translation, recorded
in the center/keypoint metadata) to the pad window around the person.

A background thread decodes batch N+1 and starts its copy to the device
while the device runs batch N.  :func:`make_batch_placer` builds the
``place`` step for the CUDA path: decode into pinned host memory, copy with
``non_blocking=True`` on a stream of its own, record an event; the loader
then orders the consumer's stream after that event before it yields the
batch.  The card's decode route on the placer's device decodes into a
tensor on the card instead, which the placer passes through after the
decoder's event (:data:`IMAGE_READY`): no image goes through the host.

Under data parallelism (``shard=(rank, world)``) every rank shuffles
with the same seed and cuts the same global batches, then decodes only its
own rows (the reference's ``P(axis)`` placement, made on the host): the
keyed draws see the global dataset indices a single process would.

Pillow is imported by :func:`_decode` only, so the native route works on a
machine without it.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from posetpu_torch.parallel.dp import check_batch, shard_slice
from posetpu_torch.utils import profiling
from posetpu_torch.utils.device import resolve_device


def _decode(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def load_sample(dataset, i, pad_hw, out=None):
    """Decode sample ``i`` and fit it into a (pad_h, pad_w) canvas
    (``out``, a (pad_h, pad_w, 3) uint8 array to fill, or a new one).

    Returns a dict of numpy arrays (image, valid_wh, center, scale, pts,
    vis, index, offset).  Images stay uint8 on the host; the device
    converts them to float.  If the decoded image exceeds the canvas, an
    integer crop window centered on the person is taken first and every
    coordinate is shifted by the integer offset: exact as long as the
    person's crop box (200 * 1.25 * scale * the largest aug scale) fits in
    ``pad_hw``; beyond it, the device samples zeros where the reference's
    host crop would read pixels.
    """
    pad_h, pad_w = pad_hw
    img = _decode(dataset.image_path(i))
    c, s, pts, vis = dataset.meta(i)
    H, W = img.shape[:2]
    off_x = off_y = 0
    if H > pad_h or W > pad_w:
        # half-up rounding, matching the C++ pool's int(c + 0.5f): the two
        # backends must pick the same window (Python round() is
        # half-to-even and diverges on *.5 centers)
        off_y = min(max(int(c[1] + 0.5) - pad_h // 2, 0), max(H - pad_h, 0))
        off_x = min(max(int(c[0] + 0.5) - pad_w // 2, 0), max(W - pad_w, 0))
        img = img[off_y : off_y + pad_h, off_x : off_x + pad_w]
        H, W = img.shape[:2]
    if out is None:
        canvas = np.zeros((pad_h, pad_w, 3), np.uint8)
    else:
        canvas = out
        canvas[H:] = 0
        canvas[:H, W:] = 0
    canvas[:H, :W] = img
    return {
        "image": canvas,
        "valid_wh": np.array([W, H], np.int32),
        "center": (c - [off_x, off_y]).astype(np.float32),
        "scale": np.float32(s),
        "pts": (pts - [off_x, off_y]).astype(np.float32),
        "vis": vis.astype(np.float32),
        "index": np.int32(i),
        # the crop-window offset, so eval maps predictions back to the
        # original image frame (center/pts above are in the cropped frame)
        "offset": np.array([off_x, off_y], np.int32),
    }


def _collate(items, image_out=None):
    return {
        k: np.stack([it[k] for it in items], out=image_out if k == "image" else None)
        for k in items[0]
    }


def pad_batch(batch, size):
    """Pad a (possibly ragged) batch to ``size`` rows and attach a ``mask``.

    The final validation batch is generally smaller than the batch size.
    Padding repeats the last sample up to the one batch shape every eval
    step runs at; the (size,) float mask marks real rows, and the eval step
    reduces with masked sums so padded rows count nowhere.  Callers trim
    per-sample outputs (preds) back to the true count.
    """
    n = next(iter(batch.values())).shape[0]
    if n > size:
        raise ValueError(f"batch of {n} larger than pad target {size}")
    mask = np.zeros((size,), np.float32)
    mask[:n] = 1.0
    if n == size:
        return {**batch, "mask": mask}
    out = {
        k: np.concatenate([v, np.repeat(v[-1:], size - n, axis=0)])
        for k, v in batch.items()
    }
    out["mask"] = mask
    return out


# the key of a batch whose image was decoded on the card: the event after
# which the image may be read (the placer's stream waits for it and drops it)
IMAGE_READY = "image_ready"


def _stack(items, host_image=None, image=None):
    """One superbatch of ``items``: every field stacked along a new leading
    dim; the images into ``host_image(shape)`` when given, or ``image``
    taken as they are (the group's tensor they were decoded into)."""
    out = {}
    for k in items[0]:
        if k == "image" and image is not None:
            out[k] = image
            continue
        parts = [np.asarray(it[k]) for it in items]
        if k == "image" and host_image is not None:
            out[k] = host_image((len(items), *parts[0].shape))
            np.stack(parts, out=out[k].numpy())
        else:
            out[k] = np.stack(parts)
    return out


def group_stack(src_iter, group, host_image=None):
    """Stack every ``group`` consecutive batches into one superbatch whose
    fields carry a leading (K, ...) group dim: the input of K train steps
    in one dispatch (:func:`posetpu_torch.train.step.make_dispatch_step`).
    The last group of an epoch may be smaller (K' < group).  With
    ``host_image(shape)`` (a placer's pinned allocator) the images are
    stacked into the tensor it returns, so the copy to the device reads
    pinned memory."""
    buf = []
    for b in src_iter:
        buf.append(b)
        if len(buf) == group:
            yield _stack(buf, host_image)
            buf = []
    if buf:
        yield _stack(buf, host_image)


# the end of a producer's source
_END = object()

# seconds an early exit waits for the producer thread to stop: the batch it
# is making (a batch of 32 MPII frames decodes in under 1 s) or a worker
# loader's own timeout (worker_loader.WORKER_TIMEOUT), with room to spare
JOIN_TIMEOUT = 300.0


def threaded_place_iter(src_iter, place, prefetch=2, epoch=None):
    """Drive ``src_iter`` from a background thread and apply ``place``
    (the copy to the device) there, so decode, collate and the copy overlap
    the training step.  The queue is abandon-safe: a consumer that exits
    early (a ``steps_per_epoch`` cap, a test's ``break``, the generator's
    collection) stops the producer, waits for it to close ``src_iter``
    (which releases what the source holds, such as worker processes) and
    drops the prefetched batches, which with ``place`` hold device memory.
    The wait is the batch the producer is making, and at most
    ``JOIN_TIMEOUT`` seconds: a producer stuck longer (a hung source)
    raises.  An exception in the producer is raised in the consumer.

    Spans and counters (:mod:`posetpu_torch.utils.profiling`), each batch
    k's spans with the unit (``epoch``, k): the producer's
    ``loader.produce`` (making the batch: the source's own spans, such as
    the decoder's), its ``loader.place`` and ``loader.put_wait`` (blocked
    on a full queue); the consumer's ``loader.wait`` (blocked in the
    queue's ``get``), marked ``first_of_epoch`` for the first batch, after
    which the unit is the consumer thread's (:func:`profiling.set_unit`)
    until the next batch or the end, so the step that takes the batch
    shares it.  ``loader.batches`` counts
    the batches handed over, ``loader.starved`` those the consumer found
    the queue empty for."""
    q = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            it, k = iter(src_iter), 0
            while True:
                with profiling.span("loader.produce", unit=(epoch, k)) as sp:
                    item = next(it, _END)
                    if item is _END:
                        sp.cancel()
                        break
                    with profiling.span("loader.place"):
                        item = place(item)
                    with profiling.span("loader.put_wait"):
                        put = _put(item)
                if not put:
                    return
                k += 1
            _put(None)
        except BaseException as e:
            _put(e)
        finally:
            close = getattr(src_iter, "close", None)
            if close is not None:
                close()

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        k = 0
        while True:
            with profiling.span("loader.wait", unit=(epoch, k)) as sp:
                try:
                    item, starved = q.get_nowait(), False
                except queue.Empty:
                    item, starved = q.get(), True
                if item is None or isinstance(item, BaseException):
                    sp.cancel()
                elif k == 0:
                    sp.mark("first_of_epoch")
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            profiling.count("loader.batches")
            if starved:
                profiling.count("loader.starved")
            profiling.set_unit((epoch, k))
            yield item
            k += 1
    finally:
        profiling.set_unit(None)
        stop.set()
        producer.join(JOIN_TIMEOUT)
        try:
            while True:
                q.get_nowait()
        except BaseException:
            # queue.Empty ends the drain; anything else is an interpreter-
            # shutdown artifact (stdlib queue's own `raise Empty` breaks
            # once module globals are cleared): the drain is best-effort
            pass
        if producer.is_alive():
            raise RuntimeError(f"the loader's producer thread did not stop within "
                               f"{JOIN_TIMEOUT:.0f} s of an early exit (a hung source?)")


class _CpuPlacer:
    """Batches as CPU tensors sharing the numpy arrays' memory."""

    device = torch.device("cpu")

    def __call__(self, batch):
        return {k: torch.as_tensor(v) for k, v in batch.items()}


def place_field(v, device):
    """One field of a batch on ``device``, on the current stream: a tensor
    already there as it is (an image decoded on the card), anything else
    pinned and copied with ``non_blocking=True``."""
    if torch.is_tensor(v) and v.device == device:
        return v
    t = torch.as_tensor(v)
    if not t.is_pinned():
        # a pinned copy of the small metadata arrays: a copy from pageable
        # memory would stall this thread
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class CudaBatchPlacer:
    """The loader's ``place`` step on a CUDA device.

    In the producer thread: :meth:`host_image` hands the loader a pinned
    uint8 tensor to decode the batch's images into; :meth:`__call__`
    makes this placer's own stream wait for a batch's :data:`IMAGE_READY`
    event (an image decoded on the card, passed through without a copy),
    copies every other field with ``non_blocking=True`` on that stream
    (:func:`place_field`) and records an event there.  In the consumer
    thread, :meth:`ready` makes the consumer's current stream wait for
    that event and calls ``record_stream`` on each device tensor, so that
    the caching allocator does not hand the batch's memory to the copy
    stream (or the decoder's) again while the compute stream may still
    read it.

    While tracing is on (:mod:`posetpu_torch.utils.profiling`) the copies
    are the device span ``loader.place`` of the producer's span of the
    same name.
    """

    def __init__(self, device):
        device = torch.device(device)
        self.device = torch.device("cuda", torch.cuda.current_device()
                                   if device.index is None else device.index)
        self.stream = torch.cuda.Stream(self.device)

    def host_image(self, shape):
        return torch.empty(tuple(shape), dtype=torch.uint8, pin_memory=True)

    def __call__(self, batch):
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            decoded = batch.get(IMAGE_READY)
            if decoded is not None:
                self.stream.wait_event(decoded)
            with profiling.device_span("loader.place", self.stream):
                out = {k: place_field(v, self.device) for k, v in batch.items()
                       if k != IMAGE_READY}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def ready(self, placed):
        tensors, done = placed
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for t in tensors.values():
            t.record_stream(current)
        return tensors


def make_batch_placer(device="cuda"):
    """The ``place`` step of :class:`HostLoader` for ``device``: on CUDA a
    :class:`CudaBatchPlacer` (pinned decode buffers, copies on a stream of
    its own, event-ordered hand-off); on the CPU the batch as tensors.
    Default CUDA; raises without it unless ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _CpuPlacer()
    return CudaBatchPlacer(dev)


class HostLoader:
    """Iterable over static-shape batches with background decode prefetch.

    ``backend``: "pil" (Pillow), "native" (the C++ parallel JPEG pool,
    :mod:`posetpu_torch.native`), "gpu" (the hand-written entropy decoder
    and the ``idct_islow`` and ``ycc_canvas`` kernels on ``device``,
    :class:`~posetpu_torch.native.GpuJpegDecoder`), or "auto": on a CUDA
    ``device`` gpu, which raises where it cannot build (the card never
    quietly decodes with Pillow); elsewhere native when it builds, Pillow
    otherwise.  Files the pool or the card's route cannot decode fall
    back to Pillow per sample, so every backend gives the same batch
    contract.  :attr:`backend` names the route taken.

    ``device``: where "gpu" decodes and what "auto" reads; None takes the
    placer's device (``place.device``), or no device at all (the CPU's
    routes; "gpu" then defaults to CUDA).

    ``place``: an optional callable applied to each collated numpy batch in
    the prefetch thread, e.g. :func:`make_batch_placer`'s, so the copy to
    the device overlaps the previous step.  A ``place`` with a
    ``host_image(shape)`` method gets the batch's images decoded straight
    into the (pinned) tensor it returns, and one with ``ready(placed)`` has
    it called on each placed batch in the consuming thread before the batch
    is yielded.  On the gpu route with a ``place`` on the decoder's device
    (its ``device``), the images are decoded into a tensor there instead
    (:meth:`GpuJpegDecoder.canvas
    <posetpu_torch.native.jpeg_gpu.GpuJpegDecoder.canvas>`): a new one for
    each batch, or superbatch with ``group``, so the batches in flight
    each hold their own (on CUDA 94.4 MB a batch of (32, 768, 1280, 3), up
    to ``prefetch`` + 2 batches or superbatches at once); the batch
    carries the decoder's event as :data:`IMAGE_READY` for the placer.

    ``group``: None (the default) yields (B, ...) batches; an int K >= 1
    stacks every K batches into one (K, B, ...) superbatch
    (:func:`group_stack`) before ``place``, K = 1 included, and the images
    then go into the placer's pinned buffer at the stacking; on the card
    batch k of a group is decoded straight into slot k of the group's
    (K, B, H, W, 3) tensor and no image is stacked.

    ``pad``: with ``drop_last`` False (validation), pad the ragged last
    batch to ``batch_size`` by :func:`pad_batch` on its dataset indices
    (the last sample repeated, decoded again) and give every batch its
    (B,) ``mask``, so every batch has the one shape the eval step runs at.

    ``shard``: None, or ``(rank, world)`` for data parallelism.
    ``batch_size`` stays the global batch; every rank orders the epoch
    alike (``seed + epoch``), cuts the same global batches (padded first
    when ``pad``) and decodes rows ``[rank*B/W, (rank+1)*B/W)`` of each
    (:func:`~posetpu_torch.parallel.dp.shard_slice`, the reference's
    ``P(axis)``; with ``group`` the stacked superbatch is then the
    reference's ``P(None, axis)``), mask included, so ``len()`` is the same
    on every rank.  A sharded loader that keeps its last batch must
    ``pad``: a ragged batch does not cut into equal slices.
    """

    def __init__(
        self,
        dataset,
        batch_size,
        pad_hw=(512, 512),
        shuffle=True,
        seed=0,
        drop_last=True,
        prefetch=2,
        backend="auto",
        place=None,
        group=None,
        pad=False,
        shard=None,
        device=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad = pad and not drop_last
        if shard is not None and not (drop_last or pad):
            raise ValueError("a sharded loader that keeps its last batch must pad it")
        self.shard = None if shard is None else tuple(shard)
        # rows a yielded batch holds: this rank's share of the global batch
        self.rows = batch_size if shard is None else check_batch(batch_size, shard[1])
        self.pad_hw = pad_hw
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.place = place
        if group is not None and group < 1:
            raise ValueError(f"group must be None or >= 1, got {group}")
        self.group = group
        self.epoch = 0
        self._decoder = None
        self._keep_canvas = False  # images decoded into a tensor on the placer's device
        if backend not in ("auto", "native", "pil", "gpu"):
            raise ValueError(f"unknown backend {backend!r} (auto, native, pil or gpu)")
        if device is None:
            device = getattr(place, "device", None)
        device = None if device is None else torch.device(device)
        if backend == "auto" and device is not None and device.type == "cuda":
            backend = "gpu"
        if backend == "gpu":
            from posetpu_torch.native.jpeg_gpu import GpuJpegDecoder

            self._decoder = GpuJpegDecoder("cuda" if device is None else device)
            self.backend = "gpu"
            self._keep_canvas = getattr(place, "device", None) == self._decoder.device
            return
        if backend in ("auto", "native"):
            try:
                from posetpu_torch.native import NativeDecoder

                self._decoder = NativeDecoder()
            except Exception:
                if backend == "native":
                    raise
        self.backend = "native" if self._decoder is not None else "pil"

    @property
    def decoder(self):
        """The decoder of the native and gpu routes (``None`` on Pillow's):
        a :class:`~posetpu_torch.native.jpeg_gpu.GpuJpegDecoder`'s ``timing``
        and ``times`` time each batch's decode, and its stages are spans of
        the producer's ``loader.produce``."""
        return self._decoder

    def _host_image(self):
        return getattr(self.place, "host_image", None)

    def _image_buffer(self, n):
        """(host array or tensor to decode into, what the batch carries as
        "image").  Grouped batches decode into plain memory: their group is
        stacked into the pinned buffer.  On the card a new tensor there."""
        shape = (n, *self.pad_hw, 3)
        if self._keep_canvas:
            t = self._decoder.canvas(shape)
            return t, t
        alloc = self._host_image() if self.group is None else None
        if alloc is None:
            arr = np.empty(shape, np.uint8)
            return arr, arr
        buf = alloc(shape)
        return buf.numpy(), buf

    def _native_batch(self, sel, out=None):
        """Decode one batch through the C++ pool or the card's route; Pillow
        fallback per failure.  The decoder writes straight into the batch's image
        buffer (``out``, a slot of its group's tensor on the card, or
        :meth:`_image_buffer`'s)."""
        ds = self.dataset
        metas = [ds.meta(int(i)) for i in sel]
        paths = [ds.image_path(int(i)) for i in sel]
        centers = np.stack([m[0] for m in metas]).astype(np.float32)
        arr, image = (out, out) if out is not None else self._image_buffer(len(sel))
        images, wh, offs, ok = self._decoder.decode_batch(
            paths, centers, self.pad_hw, out=arr
        )
        report_off = np.asarray(offs, np.int32).copy()  # surfaced to eval
        for j, i in enumerate(sel):
            if not ok[j]:  # non-JPEG / unreadable: Pillow fallback in place
                item = load_sample(ds, int(i), self.pad_hw)
                images[j] = item["image"]
                wh[j] = item["valid_wh"]
                # the item's center/pts are already shifted by its own crop
                # offset: subtract nothing below, but report the offset so
                # eval maps preds back to the original frame
                offs[j] = 0
                report_off[j] = item["offset"]
                metas[j] = (
                    item["center"].astype(np.float64),
                    float(item["scale"]),
                    item["pts"].astype(np.float64),
                    item["vis"].astype(np.float64),
                )
        offs_f = offs.astype(np.float64)
        batch = {
            "image": image,
            "valid_wh": wh,
            "center": np.stack(
                [m[0] - offs_f[j] for j, m in enumerate(metas)]
            ).astype(np.float32),
            "scale": np.asarray([m[1] for m in metas], np.float32),
            "pts": np.stack(
                [m[2] - offs_f[j] for j, m in enumerate(metas)]
            ).astype(np.float32),
            "vis": np.stack([m[3] for m in metas]).astype(np.float32),
            "index": np.asarray(sel, np.int32),
            "offset": report_off,
        }
        # on the card: the event after the last write to the image (the
        # kernel's, or a Pillow row's)
        ready = getattr(images, "ready", None)
        if ready is not None:
            batch[IMAGE_READY] = ready
        return batch

    def _pil_batch(self, sel):
        arr, image = self._image_buffer(len(sel))
        out = _collate(
            [load_sample(self.dataset, int(i), self.pad_hw) for i in sel],
            image_out=arr,
        )
        out["image"] = image
        return out

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _selections(self, order):
        """(dataset indices this process decodes, mask or None) of each
        batch of the epoch: the global batch, padded when ``pad``, or this
        rank's rows of it."""
        B = self.batch_size
        for b in range(len(self)):
            sel = {"index": order[b * B : (b + 1) * B]}
            if self.pad:
                sel = pad_batch(sel, B)
            if self.shard is not None:
                sel = shard_slice(sel, *self.shard)
            yield sel["index"], sel.get("mask")

    def _batches(self, order):
        """Plain generator of collated batches for one epoch: decode runs
        wherever it is driven from (the prefetch thread)."""
        for sel, mask in self._selections(order):
            if self._decoder is not None:
                out = self._native_batch(sel)
            else:
                out = self._pil_batch(sel)
            if mask is not None:
                out["mask"] = mask
            yield out

    def _card_groups(self, order):
        """The epoch's superbatches with their images on the decoder's
        device: batch k of a group decoded straight into slot k of one
        (K', rows, H, W, 3) tensor, the other fields stacked as
        :func:`group_stack` does, and the group's :data:`IMAGE_READY` its
        last batch's (one stream writes them all, in order)."""
        sels = list(self._selections(order))
        for start in range(0, len(sels), self.group):
            group = sels[start:start + self.group]
            canvas = self._decoder.canvas((len(group), len(group[0][0]), *self.pad_hw, 3))
            items = []
            for k, (sel, mask) in enumerate(group):
                items.append(self._native_batch(sel, out=canvas[k]))
                if mask is not None:
                    items[-1]["mask"] = mask
            ready = items[-1].get(IMAGE_READY)
            out = _stack([{k: v for k, v in it.items() if k != IMAGE_READY} for it in items],
                         image=canvas)
            if ready is not None:
                out[IMAGE_READY] = ready
            yield out

    def __iter__(self):
        order = self._order()
        epoch = self.epoch
        self.epoch += 1
        profiling.count("loader.epochs")
        if self.group is None:
            src = self._batches(order)
        elif self._keep_canvas:
            src = self._card_groups(order)
        else:
            src = group_stack(self._batches(order), self.group, host_image=self._host_image())
        place = self.place if self.place is not None else (lambda b: b)
        ready = getattr(self.place, "ready", None)
        # decode, collate, stacking and the copy run in the producer
        # thread; the consumer only orders its stream after each ready batch
        it = threaded_place_iter(src, place, prefetch=self.prefetch, epoch=epoch)
        try:
            for item in it:
                yield item if ready is None else ready(item)
        finally:
            it.close()  # an early exit releases the producer now
