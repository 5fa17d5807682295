"""posetpu_torch — PyTorch/CUDA port of :mod:`posetpu` for NVIDIA Hopper.

The JAX package ``posetpu`` is the reference; this package is its
counterpart, module for module (``posetpu/aug/warp.py`` ->
``posetpu_torch/aug/warp.py`` and so on).  It imports torch and numpy only,
never JAX or anything under ``posetpu``.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when CUDA is absent, unless the caller asks for ``"cpu"``.  On a CUDA
tensor every kernel wrapper launches its hand-written kernel (built from
the sources in this package at first use); on a CPU tensor it runs the
kernel's plain PyTorch version.

Ported so far: the serving path (:class:`posetpu_torch.infer.PosePredictor`),
the validation, train and joint adversarial steps (:mod:`posetpu_torch.train`),
the data layer and host loader (:mod:`posetpu_torch.data`) with its C++ JPEG
pool (:mod:`posetpu_torch.native`), the epoch driver
(:class:`posetpu_torch.train.loop.Experiment`), the command lines
``python -m posetpu_torch.train.cli`` and ``python -m posetpu_torch.eval.cli``,
data parallelism across GPUs (:mod:`posetpu_torch.parallel`), and the
bench, ``python -m posetpu_torch.bench`` (:mod:`posetpu_torch.bench`).
"""
