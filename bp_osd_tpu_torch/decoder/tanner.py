"""Tanner-graph layout of a GF(2) parity-check matrix, as torch tensors.

Port of ``bp_osd_tpu/decoder/tanner.py``.  The graph is compiled once into
fixed-shape, padded index tensors on one device:

- ``chk_var [m, wr]`` int32: variable ids incident to each check, padded with
  the sentinel ``n``.  Flat edge ``e = check * wr + slot``.
- ``var_edge [n, wc]`` int32: flat edge ids incident to each variable in
  ascending order, padded with the sentinel ``m * wr``.
- ``H_packed [m, ceil(n/32)]`` int32: row-packed PCM, uint32 words (bit ``v``
  of word ``w`` is column ``32w + v``) stored as int32.
- ``H_cols [n, ceil(m/32)]`` int32: column-packed PCM (bit ``i`` of word ``w``
  of row ``c`` is ``H[32w + i, c]``), the column layout of the OSD matrix; not
  a field of the JAX graph.
- ``chk_deg [m]`` int32: the degree of each check (its count of
  ``chk_var < n``), which kernel K1 reads instead of scanning a row; not a
  field of the JAX graph.

The JAX graph's pytree protocol and its one-hot ``edge_var_onehot`` operator
(a TPU device that routes gathers through the matrix unit) have no
counterpart: the plain torch path gathers through the index tensors and the
CUDA kernels read them from shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import gf2

__all__ = ["BACKENDS", "TannerGraph", "canonical_device", "resolve_backend", "resolve_device"]

BACKENDS = ("auto", "cuda", "torch")


def canonical_device(device) -> torch.device:
    """``torch.device`` with the index filled in (``cuda`` -> ``cuda:<current>``),
    so that it compares equal to the device of a tensor placed there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device=None, backend: str = "auto") -> torch.device:
    """The device a graph or decoder is placed on, canonical.

    An explicit ``device`` is taken as given.  With ``device=None``, backend
    ``"cuda"`` asks for the card and ``"torch"`` for the CPU; ``"auto"``
    takes the card when ``torch.cuda.is_available()``, else the CPU.  A
    ``backend`` outside :data:`BACKENDS` raises ``ValueError``; a ``cuda``
    device without a card raises ``RuntimeError``: nothing falls back to
    the CPU."""
    _check_backend(backend)
    if device is None:
        on_card = backend == "cuda" or (backend == "auto" and torch.cuda.is_available())
        device = "cuda" if on_card else "cpu"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA card; "
                           "torch.cuda.is_available() is false")
    return canonical_device(device)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def resolve_backend(backend: str, device) -> str:
    """Map ``backend`` in :data:`BACKENDS` to ``"cuda"`` or ``"torch"``: the
    one check of ``backend`` a public entry point makes.

    The tensors' device decides what runs (the CUDA kernels on a card, their
    plain torch versions elsewhere), so ``"auto"`` follows ``device``, and
    ``"cuda"`` on CPU tensors and ``"torch"`` on CUDA tensors raise: nothing
    falls back to another device or path.
    """
    _check_backend(backend)
    on_card = torch.device(device).type == "cuda"
    if backend == "cuda" and not on_card:
        raise RuntimeError(
            "backend='cuda' needs the inputs on a CUDA device "
            f"(got {device}; torch.cuda.is_available()="
            f"{torch.cuda.is_available()})"
        )
    if backend == "torch" and on_card:
        raise ValueError(
            "CUDA tensors always go to the kernels: backend='torch' takes CPU "
            "tensors (call the plain *_plain function to run it on the card)"
        )
    return "cuda" if on_card else "torch"


class TannerGraph:
    """Static decode-time layout of a parity-check matrix on ``device``
    (default: :func:`resolve_device`, the card when there is one)."""

    _FIELDS = ("chk_var", "chk_mask", "var_edge", "var_mask", "H_packed")
    _INTS = ("m", "n", "wr", "wc", "num_words", "rank")
    _DERIVED = ("H_cols", "chk_deg")

    def __init__(self, H, device=None):
        Hd = gf2.to_dense(H)
        m, n = Hd.shape
        if m == 0 or n == 0:
            raise ValueError("parity check matrix must be non-empty")
        self.H = Hd
        self.m = m
        self.n = n
        self.device = resolve_device(device)

        rows, cols = np.nonzero(Hd)  # row-major: sorted by (row, col)
        self.num_edges = int(rows.size)
        row_counts = np.bincount(rows, minlength=m)
        col_counts = np.bincount(cols, minlength=n)
        self.wr = int(row_counts.max()) if rows.size else 1
        self.wc = int(col_counts.max()) if cols.size else 1

        slot = (np.concatenate([np.arange(c) for c in row_counts])
                if rows.size else np.zeros(0, int))
        chk_var = np.full((m, self.wr), n, dtype=np.int32)
        chk_var[rows, slot] = cols
        edge_flat = rows * self.wr + slot

        # variable-major view, check order (= ascending flat edge id)
        order = np.lexsort((rows, cols))
        vslot = (np.concatenate([np.arange(c) for c in col_counts])
                 if cols.size else np.zeros(0, int))
        var_edge = np.full((n, self.wc), m * self.wr, dtype=np.int32)
        var_edge[cols[order], vslot] = edge_flat[order]

        packed64, _ = gf2.pack_rows(Hd)
        self.num_words = -(-n // 32)
        by = np.ascontiguousarray(packed64).view(np.uint32)
        h_packed = np.ascontiguousarray(by[:, : self.num_words]).view(np.int32)
        cols = np.packbits(Hd.T, axis=1, bitorder="little")  # [n, ceil(m/8)] bytes
        cols = np.pad(cols, ((0, 0), (0, 4 * -(-m // 32) - cols.shape[1])))
        h_cols = np.ascontiguousarray(cols).view("<u4").view(np.int32)

        # GF(2) rank is column-permutation invariant: every per-sample OSD
        # elimination finds exactly `rank` pivots, whatever the order
        self.rank = gf2.rank(Hd)

        dev = self.device
        self.chk_var = torch.from_numpy(chk_var).to(dev)
        self.chk_mask = self.chk_var != n
        self.var_edge = torch.from_numpy(var_edge).to(dev)
        self.var_mask = self.var_edge != m * self.wr
        self.H_packed = torch.from_numpy(h_packed).to(dev)
        self.H_cols = torch.from_numpy(h_cols).to(dev)
        self.chk_deg = torch.from_numpy(row_counts.astype(np.int32)).to(dev)

    def to(self, device) -> "TannerGraph":
        """The same graph with its tensors on ``device``."""
        device = canonical_device(device)
        if device == self.device:
            return self
        g = object.__new__(TannerGraph)
        g.__dict__.update(self.__dict__)
        g.device = device
        for f in self._FIELDS + self._DERIVED:
            setattr(g, f, getattr(self, f).to(device))
        return g

    def fields(self) -> dict:
        """The JAX graph's leaves and ints, as numpy arrays and Python ints."""
        out = {f: getattr(self, f).cpu().numpy() for f in self._FIELDS}
        out.update({k: getattr(self, k) for k in self._INTS})
        return out

    @classmethod
    def from_reference(cls, fields: dict, device=None) -> "TannerGraph":
        """Build the graph from a JAX ``TannerGraph``'s numpy leaves and ints.

        ``fields`` holds ``chk_var chk_mask var_edge var_mask H_packed`` (numpy,
        ``H_packed`` as uint32 or int32) and ``m n wr wc num_words rank``.  H
        is unpacked from ``H_packed``; every field must equal what this class
        computes from that H, else ``ValueError``.
        """
        m, n = int(fields["m"]), int(fields["n"])
        words = np.ascontiguousarray(fields["H_packed"]).view(np.uint32)
        bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        H = bits.reshape(m, -1)[:, :n].astype(np.uint8)
        g = cls(H, device)
        mine = g.fields()
        for f in cls._FIELDS:
            ref = np.asarray(fields[f])
            if f == "H_packed":
                ref = np.ascontiguousarray(ref).view(np.int32)
            if not np.array_equal(mine[f], ref):
                raise ValueError(f"reference field {f!r} differs from the port's")
        for k in cls._INTS:
            if int(fields[k]) != mine[k]:
                raise ValueError(
                    f"reference {k}={fields[k]} differs from the port's {mine[k]}")
        return g

    def __repr__(self) -> str:
        return (
            f"TannerGraph(m={self.m}, n={self.n}, edges={self.num_edges}, "
            f"wr={self.wr}, wc={self.wc}, rank={self.rank}, "
            f"device={self.device})"
        )
