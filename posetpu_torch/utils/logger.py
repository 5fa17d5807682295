"""Append-mode txt logger and curve plot — the port's own copy of
``posetpu/utils/logger.py``: fixed tab-separated columns (``Epoch  LR  Train
Loss  Val Loss  Train Acc  Val Acc``, floats as ``%.6f``), byte for byte the
JAX package's ``log.txt`` for the same rows, with an optional matplotlib
curve dump.  Reopens in append mode on resume, skipping a partial last line.
"""

from __future__ import annotations

import os


class Logger:
    DEFAULT_NAMES = ("Epoch", "LR", "Train Loss", "Val Loss", "Train Acc", "Val Acc")

    def __init__(self, fpath, resume=False):
        self.fpath = fpath
        self.names = []
        self.numbers = {}
        if resume and os.path.exists(fpath):
            with open(fpath) as f:
                header = f.readline().rstrip("\n")
                # empty file (crash before the header flushed): treat as a
                # fresh log instead of inheriting names=[''] that would
                # fail every append
                self.names = header.split("\t") if header else []
                self.numbers = {n: [] for n in self.names}
                for line in f:
                    vals = line.rstrip("\n").split("\t")
                    if len(vals) != len(self.names):
                        continue  # partial last line from a mid-write crash
                    try:
                        parsed = [float(v) for v in vals]
                    except ValueError:
                        continue
                    for n, v in zip(self.names, parsed):
                        self.numbers[n].append(v)
            self.file = open(fpath, "a" if self.names else "w")
        else:
            os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
            self.file = open(fpath, "w")

    def set_names(self, names):
        if self.names:  # resumed: header already present
            return
        self.names = list(names)
        self.numbers = {n: [] for n in self.names}
        self.file.write("\t".join(self.names) + "\n")
        self.file.flush()

    def append(self, values):
        if len(values) != len(self.names):
            raise ValueError(f"{len(values)} values for {len(self.names)} columns")
        self.file.write(
            "\t".join(f"{v:.6f}" if isinstance(v, float) else str(v) for v in values)
            + "\n"
        )
        self.file.flush()
        for n, v in zip(self.names, values):
            self.numbers[n].append(float(v))

    def plot(self, names=None, path=None):
        """Loss/acc curves like the reference's ``savefig`` (headless Agg).
        Needs matplotlib; callers that must not fail catch its error."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names = names or [n for n in self.names if n != "Epoch"]
        xs = self.numbers.get("Epoch", range(len(next(iter(self.numbers.values()), []))))
        fig, ax = plt.subplots(figsize=(8, 5))
        for n in names:
            ax.plot(xs, self.numbers[n], label=n)
        ax.legend()
        ax.grid(True)
        out = path or self.fpath.replace(".txt", ".png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out

    def close(self):
        self.file.close()


class AverageMeter:
    """Running mean tracker (the reference's ``AverageMeter``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0
