"""Monte-Carlo BP+OSD decoding simulation for CSS codes.

Port of ``bp_osd_tpu/sim/css_decode_sim.py``: the same experiment, config
dict, prints and JSON output.  A batch is one draw of uniforms
``torch.rand(B, N)`` from a ``torch.Generator`` seeded with ``seed`` on the
simulation's device, then :meth:`css_decode_sim._batch_stats`, a function of
those uniforms alone: biased X/Y/Z errors, both syndromes, the two-sided
X/Z decode with the optional Bayes channel update, and the logical outcome
of every sample.  Fed the JAX harness's uniforms, it gives the JAX
harness's per-sample outcomes.

``backend`` takes ``auto|cuda|torch`` as
:func:`~bp_osd_tpu_torch.decoder.tanner.resolve_backend` reads them: ``auto``
runs on the card when ``torch.cuda.is_available()`` (every decode through the
CUDA kernels), else on the CPU (their plain torch versions).

``use_mesh=1`` shards each batch over a device mesh
(:mod:`bp_osd_tpu_torch.parallel`): ``mesh``, else all the cards
(``make_mesh()``) in one process, else the process's own device.  The batch
size is rounded up to a multiple of the shard count, and the uniforms are
those the ``use_mesh=0`` run draws, so every per-sample outcome and every
counter equals the unsharded run's.  With several processes
(:func:`bp_osd_tpu_torch.parallel.initialize`) each rank runs on its own
card (:func:`~bp_osd_tpu_torch.parallel.distributed.local_card`, unless
``mesh`` says otherwise), draws the whole batch from the same seed, decodes
its ``host_batch_slice``, and the batch's counts are reduced over all ranks,
so every rank holds the same totals; the last batch is not trimmed
(``run_count`` may overshoot ``target_runs`` by less than ``batch_size``),
and only rank 0 writes ``output_file``.

``use_mesh=-1`` means 1 with more than one process, else 0.  The JAX
harness also takes the mesh for one process with several devices; here the
shards of one process share its interpreter and each pays the pipeline's
host time, so such a mesh decodes the harness's batches slower than one
card.
"""

from __future__ import annotations

import datetime
import json
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..codes.css import css_code
from ..decoder.bp import llr_from_channel
from ..decoder.bposd import _CHUNK_CARD, _CHUNK_CPU
from ..decoder.osd import build_osd_consts, normalize_osd_method
from ..decoder.pipeline import BpOsdBatch, _decode_pipeline
from ..decoder.tanner import TannerGraph, canonical_device, resolve_backend, resolve_device
from ..parallel import Mesh, make_mesh, shard_batch_fn
from ..parallel.distributed import (host_batch_slice, local_card, process_count,
                                    process_index, reduce_batch_counts)
from ..parallel.shard_pallas import replicate

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None

__all__ = ["css_decode_sim"]

_DEFAULT_INPUT = {
    "error_rate": None,
    "xyz_error_bias": [1, 1, 1],
    "target_runs": 100,
    "seed": 0,
    "bp_method": "minimum_sum",
    "ms_scaling_factor": 0.625,
    "max_iter": 0,
    "osd_method": "osd_cs",
    "osd_order": 2,
    "save_interval": 2,
    "output_file": None,
    "check_code": 1,
    "tqdm_disable": 0,
    "run_sim": 1,
    "channel_update": "x->z",
    "hadamard_rotate": 0,
    "hadamard_rotate_sector1_length": 0,
    "error_bar_precision_cutoff": 1e-3,
    "batch_size": 0,  # 0 -> min(target_runs, 16384) on the card, 1024 on the CPU
    "use_mesh": -1,  # -1 -> 1 with more than one process, else 0
    "mesh": None,  # use_mesh's devices: None -> every card (one process), else this rank's
    "backend": "auto",  # auto | cuda | torch
}

_OUTPUT_VALUES = {
    "K": None,
    "N": None,
    "start_date": None,
    "runtime": 0.0,
    "runtime_readable": None,
    "run_count": 0,
    "bp_converge_count_x": 0,
    "bp_converge_count_z": 0,
    "bp_success_count": 0,
    "bp_logical_error_rate": 0,
    "bp_logical_error_rate_eb": 0,
    "osd0_success_count": 0,
    "osd0_logical_error_rate": 0.0,
    "osd0_logical_error_rate_eb": 0.0,
    "osdw_success_count": 0,
    "osdw_logical_error_rate": 0.0,
    "osdw_logical_error_rate_eb": 0.0,
    "osdw_word_error_rate": 0.0,
    "osdw_word_error_rate_eb": 0.0,
    "min_logical_weight": 1e9,
}

# attributes never serialized (matrices, channel vectors, the mesh)
_NON_OUTPUT = {
    "channel_probs_x",
    "channel_probs_z",
    "channel_probs_y",
    "hx",
    "hz",
    "mesh",
}

# per-sample outcomes summed into the counters, in the order of _COUNTERS
_COUNTED = ("osdw_success", "osd0_success", "bp_success", "bp_converge_x", "bp_converge_z")
_COUNTERS = ("osdw_success_count", "osd0_success_count", "bp_success_count",
             "bp_converge_count_x", "bp_converge_count_z")


def _mod2mul(a: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``a @ M.T mod 2`` of 0/1 matrices as uint8 (f32 counts are exact far
    beyond any block length here)."""
    return torch.remainder(a.to(torch.float32) @ M.T, 2).to(torch.uint8)


def _bayes_llrs(p_first, p_other, p_y):
    """Prior LLRs of the second decoder's qubits after the first decoder's
    correction, as ``(llr where it flipped the qubit, llr where it did not)``.

    The posterior is ``p_y / (p_first + p_y)`` on a flipped qubit and
    ``p_other / (1 - p_first - p_y)`` elsewhere, in float32 and the JAX
    harness's operation order.  ``llr`` is elementwise, so selecting between
    the two per sample equals the LLR of the selected posterior.
    """
    denom_hit = p_first + p_y
    p_hit = torch.where(denom_hit > 0, p_y / torch.clamp(denom_hit, min=1e-30), 0.0)
    p_miss = p_other / torch.clamp(1.0 - p_first - p_y, min=1e-30)
    return llr_from_channel(p_hit), llr_from_channel(p_miss)


class _OnDevice:
    """The harness's code, channel and per-side decoders on one device, and
    what it does with a batch of uniforms there.  :meth:`to` copies it to
    another device (a mesh shard's)."""

    def __init__(self, *, codes, bands, sides, decode_kw, chunk, channel_update):
        self._codes = codes  # dense f32 (hx, hz, lx, lz)
        self._bands = bands
        self._sides = sides
        self._decode_kw = decode_kw
        self._chunk = chunk
        self.channel_update = channel_update
        self.device = bands[0].device

    def to(self, device) -> "_OnDevice":
        device = canonical_device(device)
        if device == self.device:
            return self
        codes, bands, sides = replicate((self._codes, self._bands, self._sides), device)
        return _OnDevice(codes=codes, bands=bands, sides=sides, decode_kw=self._decode_kw,
                         chunk=self._chunk, channel_update=self.channel_update)

    def sample(self, rand: torch.Tensor):
        """Errors and syndromes of uniforms ``rand [B, N]``: ``(error_x,
        error_z, synd_x, synd_z)``, X errors checked by hz, Z errors by hx."""
        z_hi, x_hi, y_hi = self._bands
        band_z = rand < z_hi
        band_x = (rand >= z_hi) & (rand < x_hi)
        band_y = (rand >= x_hi) & (rand < y_hi)
        error_z = (band_z | band_y).to(torch.uint8)
        error_x = (band_x | band_y).to(torch.uint8)
        hx, hz = self._codes[:2]
        return error_x, error_z, _mod2mul(error_x, hz), _mod2mul(error_z, hx)

    def decode_side(self, side: str, synd: torch.Tensor,
                    first_osdw: torch.Tensor | None = None) -> BpOsdBatch:
        """BP+OSD of one side's syndromes, in chunks of the decoder's size.

        ``first_osdw``, the osdw of the side decoded first, selects each
        qubit's Bayes-updated prior.
        """
        graph, consts, llr0, bayes = self._sides[side]
        if first_osdw is not None:
            hit, miss = bayes
            llr0 = torch.where(first_osdw == 1, hit, miss)
        c = self._chunk
        outs = [_decode_pipeline(graph, synd[lo:lo + c],
                                 llr0 if llr0.dim() == 1 else llr0[lo:lo + c],
                                 consts=consts, **self._decode_kw)
                for lo in range(0, synd.shape[0], c)]
        if len(outs) == 1:
            return outs[0]
        return BpOsdBatch(*(torch.cat(xs) for xs in zip(*outs)))

    def decode(self, synd_x: torch.Tensor, synd_z: torch.Tensor):
        """Both sides in the order ``channel_update`` gives; ``(out_x, out_z)``."""
        if self.channel_update == "x->z":
            out_x = self.decode_side("x", synd_x)
            return out_x, self.decode_side("z", synd_z, out_x.osdw)
        out_z = self.decode_side("z", synd_z)
        first = out_z.osdw if self.channel_update == "z->x" else None
        return self.decode_side("x", synd_x, first), out_z

    def outcomes(self, error_x, error_z, out_x: BpOsdBatch, out_z: BpOsdBatch) -> dict:
        """Per-sample outcomes of one decoded batch."""
        lx, lz = self._codes[2:]

        def logical(corr_x, corr_z):
            """(success, weight of the failing component) per sample: a
            logical X error is checked first; 10^9 where none failed."""
            res_x = error_x ^ corr_x
            res_z = error_z ^ corr_z
            log_x = (_mod2mul(res_x, lz) == 1).any(1)
            log_z = (_mod2mul(res_z, lx) == 1).any(1)
            weight = torch.where(log_x, res_x.sum(1, dtype=torch.int64),
                                 torch.where(log_z, res_z.sum(1, dtype=torch.int64), 10**9))
            return ~(log_x | log_z), weight

        osdw_success, osdw_weight = logical(out_x.osdw, out_z.osdw)
        osd0_success, osd0_weight = logical(out_x.osd0, out_z.osd0)
        bp_logical, _ = logical(out_x.bp_hard, out_z.bp_hard)
        return {
            "osdw_success": osdw_success,
            "osd0_success": osd0_success,
            "bp_success": out_x.converged & out_z.converged & bp_logical,
            "bp_converge_x": out_x.converged,
            "bp_converge_z": out_z.converged,
            "logical_weight": torch.minimum(osdw_weight, osd0_weight),
        }

    def batch_stats(self, rand: torch.Tensor) -> dict:
        """Per-sample outcomes ``[B]`` of uniforms ``rand [B, N]``:
        ``osdw_success``, ``osd0_success``, ``bp_success``,
        ``bp_converge_x``, ``bp_converge_z`` (bool) and ``logical_weight``
        (int64, 10^9 where neither decoding failed)."""
        error_x, error_z, synd_x, synd_z = self.sample(rand)
        out_x, out_z = self.decode(synd_x, synd_z)
        return self.outcomes(error_x, error_z, out_x, out_z)


class css_decode_sim:
    """Batched Monte-Carlo logical-error-rate experiment for a CSS code.

    Accepts parameters directly or as a dict; a previously saved output dict
    resumes the run (counters restored, seed re-randomized).
    """

    def __init__(self, hx=None, hz=None, **input_dict):
        for key, value in input_dict.items():
            self.__dict__[key] = value
        for key, value in _DEFAULT_INPUT.items():
            if key not in input_dict:
                self.__dict__[key] = value
        for key, value in _OUTPUT_VALUES.items():
            if key not in self.__dict__:
                self.__dict__[key] = value

        self.output_keys = [key for key in self.__dict__ if key not in _NON_OUTPUT]

        if self.seed == 0 or self.run_count != 0:
            self.seed = int(np.random.randint(low=1, high=2**32 - 1))
        print(f"RNG Seed: {self.seed}")

        self.hx = sp.csr_matrix(hx).astype(np.uint8)
        self.hz = sp.csr_matrix(hz).astype(np.uint8)
        self.N = self.hx.shape[1]
        if self.min_logical_weight == 1e9:
            self.min_logical_weight = int(self.N)

        self._construct_code()
        self._error_channel_setup()
        self._decoder_setup()

        if self.run_sim:
            self.run_decode_sim()

    # -- setup --------------------------------------------------------------

    def _construct_code(self):
        print("Constructing CSS code from hx and hz matrices...")
        qcode = css_code(self.hx, self.hz)
        self.lx = qcode.lx
        self.lz = qcode.lz
        self.K = qcode.K
        self.N = qcode.N
        if self.check_code:
            print("Checking the CSS code is valid...")
            if not qcode.test(show_tests=False):
                raise Exception(
                    "Error: invalid CSS code. Check the form of your hx and "
                    "hz matrices!"
                )

    def _error_channel_setup(self):
        """Biased X/Y/Z channel split and optional Hadamard-rotated sectors."""
        bias = np.array(self.xyz_error_bias, dtype=np.float64)
        if bias[0] == np.inf:
            self.px, self.py, self.pz = float(self.error_rate), 0.0, 0.0
        elif bias[1] == np.inf:
            self.px, self.py, self.pz = 0.0, float(self.error_rate), 0.0
        elif bias[2] == np.inf:
            self.px, self.py, self.pz = 0.0, 0.0, float(self.error_rate)
        else:
            self.px, self.py, self.pz = float(self.error_rate) * bias / np.sum(bias)

        if self.hadamard_rotate == 0:
            self.channel_probs_x = np.full(self.N, self.px)
            self.channel_probs_z = np.full(self.N, self.pz)
            self.channel_probs_y = np.full(self.N, self.py)
        elif self.hadamard_rotate == 1:
            n1 = int(self.hadamard_rotate_sector1_length)
            self.channel_probs_x = np.hstack(
                [np.full(n1, self.px), np.full(self.N - n1, self.pz)]
            )
            self.channel_probs_z = np.hstack(
                [np.full(n1, self.pz), np.full(self.N - n1, self.px)]
            )
            self.channel_probs_y = np.full(self.N, self.py)
        else:
            raise ValueError(
                f"The hadamard rotate attribute should be set to 0 or 1. "
                f"Not '{self.hadamard_rotate}'"
            )

    def _decoder_setup(self):
        """Place the code, the channel and one decoder per side on the device."""
        if self.channel_update not in (None, "x->z", "z->x"):
            raise ValueError(
                f"channel_update must be None, 'x->z' or 'z->x', "
                f"got {self.channel_update!r}"
            )
        dev = resolve_device(None, self.backend)
        on_card = dev.type == "cuda"
        ranks = process_count() > 1
        if self.use_mesh == -1:
            self.use_mesh = 1 if ranks else 0
        given = self.use_mesh and self.mesh is not None
        if on_card and given:
            dev = self.mesh.devices[0]
        elif on_card and ranks:
            dev = local_card()
        self._device = dev
        self.backend = resolve_backend(self.backend, dev)
        if self.batch_size == 0:
            cap = 16384 if on_card else 1024
            self.batch_size = int(min(max(self.target_runs, 1), cap))
        if self.use_mesh:
            mesh = (self.mesh if given else make_mesh() if on_card and not ranks
                    else Mesh((dev,)))
            if any(d.type != dev.type for d in mesh.devices):
                raise ValueError(f"the mesh's devices {mesh.devices} are not the harness's "
                                 f"{dev.type} (backend={self.backend!r})")
            shards = process_count() * len(mesh)
            # round up so the batch shards evenly over every rank's mesh
            self.batch_size += -self.batch_size % shards
            self._sharded = shard_batch_fn(lambda rand, on: on.batch_stats(rand), mesh)
        self._chunk = _CHUNK_CARD if on_card else _CHUNK_CPU
        self.ms_scaling_factor = float(self.ms_scaling_factor)
        osd_method = normalize_osd_method(self.osd_method)
        self._decode_kw = dict(
            bp_method=self.bp_method, max_iter=int(self.max_iter),
            ms_scaling_factor=self.ms_scaling_factor, osd_method=osd_method,
            osd_order=int(self.osd_order),
        )

        def dense(M):
            return torch.as_tensor(np.asarray(M.toarray(), np.float32), device=dev)

        p = {s: torch.as_tensor(np.asarray(v, np.float32)) for s, v in
             (("x", self.channel_probs_x), ("y", self.channel_probs_y),
              ("z", self.channel_probs_z))}
        # per side (Z errors against hx, X errors against hz): the graph, the
        # OSD tables, the prior, and the Bayes pair when the other side goes first
        sides = {}
        for side, other, H in (("z", "x", self.hx), ("x", "z", self.hz)):
            graph = TannerGraph(H.toarray(), dev)
            consts = build_osd_consts(graph, osd_method, int(self.osd_order))
            prior = llr_from_channel(p[side] + p["y"]).to(dev)
            bayes = None
            if self.channel_update == f"{other}->{side}":
                bayes = tuple(t.to(dev) for t in _bayes_llrs(p[other], p[side], p["y"]))
            sides[side] = (graph, consts, prior, bayes)
        self._on = _OnDevice(
            codes=(dense(self.hx), dense(self.hz), dense(self.lx), dense(self.lz)),
            # band edges of one uniform: [0, pz) Z, [pz, pz+px) X, then Y
            bands=tuple(b.to(dev) for b in (p["z"], p["z"] + p["x"], p["z"] + p["x"] + p["y"])),
            sides=sides, decode_kw=self._decode_kw, chunk=self._chunk,
            channel_update=self.channel_update)

    # -- one batch ----------------------------------------------------------

    def _draw(self) -> torch.Tensor:
        """The next batch's uniforms ``[batch_size, N]``."""
        return torch.rand(self.batch_size, self.N, generator=self._gen, device=self._device)

    def _sample(self, rand: torch.Tensor):
        return self._on.sample(rand)

    def _decode_side(self, side: str, synd: torch.Tensor,
                     first_osdw: torch.Tensor | None = None) -> BpOsdBatch:
        return self._on.decode_side(side, synd, first_osdw)

    def _outcomes(self, error_x, error_z, out_x: BpOsdBatch, out_z: BpOsdBatch) -> dict:
        return self._on.outcomes(error_x, error_z, out_x, out_z)

    def _batch_stats(self, rand: torch.Tensor) -> dict:
        """Per-sample outcomes of uniforms ``rand [B, N]`` on the harness's
        device (:meth:`_OnDevice.batch_stats`)."""
        return self._on.batch_stats(rand)

    def _stats(self, rand: torch.Tensor) -> dict:
        """:meth:`_batch_stats`, sharded over the mesh with ``use_mesh``."""
        return self._sharded(rand, self._on) if self.use_mesh else self._on.batch_stats(rand)

    # -- statistics ---------------------------------------------------------

    def _update_error_rates(self):
        """Logical/word error rates with binomial error bars."""
        n = max(self.run_count, 1)

        def rates(success_count):
            ler = 1 - success_count / n
            eb = np.sqrt((1 - ler) * ler / n)
            wer = 1.0 - (1 - ler) ** (1 / self.K)
            wer_eb = eb * ((1 - eb) ** (1 / self.K - 1)) / self.K
            return ler, eb, wer, wer_eb

        (
            self.osdw_logical_error_rate,
            self.osdw_logical_error_rate_eb,
            self.osdw_word_error_rate,
            self.osdw_word_error_rate_eb,
        ) = rates(self.osdw_success_count)
        (
            self.osd0_logical_error_rate,
            self.osd0_logical_error_rate_eb,
            self.osd0_word_error_rate,
            self.osd0_word_error_rate_eb,
        ) = rates(self.osd0_success_count)
        (
            self.bp_logical_error_rate,
            self.bp_logical_error_rate_eb,
            self.bp_word_error_rate,
            self.bp_word_error_rate_eb,
        ) = rates(self.bp_success_count)

    # -- main loop ----------------------------------------------------------

    def run_decode_sim(self):
        """Main simulation loop: one batch per step, periodic JSON
        checkpoints, early stop at the error-bar precision cutoff.  A partial
        final batch counts only the samples the target still needs."""
        self.start_date = datetime.datetime.fromtimestamp(
            time.time()
        ).strftime("%A, %B %d, %Y %H:%M:%S")

        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(self.seed)
        start_time = time.time()
        save_time = start_time

        pbar = None
        if tqdm is not None and not self.tqdm_disable:
            pbar = tqdm(total=self.target_runs, initial=self.run_count, ncols=0)

        # several processes: each decodes its slice of every batch, and the
        # batch's counts are summed over all of them, so no batch is trimmed
        ranks = bool(self.use_mesh) and process_count() > 1
        while self.run_count < self.target_runs:
            rand = self._draw()
            if ranks:
                take = self.batch_size
                start, keep = host_batch_slice(take)
                stats = self._stats(rand[start:start + keep])
            else:
                take = keep = min(self.batch_size, self.target_runs - self.run_count)
                stats = self._stats(rand)
            # one host transfer per batch: the five counts and the min weight
            *counts, batch_min_weight = torch.stack(
                [stats[k][:keep].sum() for k in _COUNTED]
                + [stats["logical_weight"][:keep].min()]
            ).tolist()
            if ranks:
                counts, batch_min_weight = reduce_batch_counts(counts, batch_min_weight)
            self.run_count += take
            for key, count in zip(_COUNTERS, counts):
                self.__dict__[key] += count
            if batch_min_weight < self.min_logical_weight:
                self.min_logical_weight = batch_min_weight

            self._update_error_rates()

            if pbar is not None:
                pbar.update(take)
                pbar.set_description(
                    f"d_max: {self.min_logical_weight}; "
                    f"OSDW_WER: {self.osdw_word_error_rate * 100:.3g}±"
                    f"{self.osdw_word_error_rate_eb * 100:.2g}%; "
                    f"OSDW: {self.osdw_logical_error_rate * 100:.3g}±"
                    f"{self.osdw_logical_error_rate_eb * 100:.2g}%; "
                    f"OSD0: {self.osd0_logical_error_rate * 100:.3g}±"
                    f"{self.osd0_logical_error_rate_eb * 100:.2g}%;"
                )

            current_time = time.time()
            save_loop = current_time - save_time
            if int(save_loop) > self.save_interval or self.run_count >= self.target_runs:
                save_time = current_time
                self.runtime = save_loop + self.runtime
                self.runtime_readable = time.strftime(
                    "%H:%M:%S", time.gmtime(self.runtime)
                )
                # every rank holds the same totals; rank 0 owns the file
                if self.output_file is not None and process_index() == 0:
                    with open(self.output_file, "w+") as f:
                        print(self.output_dict(), file=f)
                if (
                    self.osdw_logical_error_rate_eb > 0
                    and self.osdw_logical_error_rate_eb
                    / max(self.osdw_logical_error_rate, 1e-100)
                    < self.error_bar_precision_cutoff
                ):
                    print(
                        "\nTarget error bar precision reached. "
                        "Stopping simulation..."
                    )
                    break

        if pbar is not None:
            pbar.close()
        return self.output_dict()

    def output_dict(self):
        """JSON string of all scalar state (the reference file format)."""
        out = {}
        for key, value in self.__dict__.items():
            if key in self.output_keys:
                if isinstance(value, (np.integer,)):
                    value = int(value)
                elif isinstance(value, (np.floating,)):
                    value = float(value)
                out[key] = value
        return json.dumps(out, sort_keys=True, indent=4)
