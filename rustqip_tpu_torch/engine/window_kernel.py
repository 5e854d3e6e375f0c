"""The strip-window sweep: host planning helpers, the step-program encoder,
the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``rustqip_tpu/engine/pallas_kernels.py`` (the JAX package's one
TPU kernel: ``window_sweep``:1155 / ``_window_sweep_pipelined``:1029 with
body ``_window_kernel_body``:308, and ``c64_low_matmul``:1328). The host
side is ported exactly: ``_specialize_groups``, ``window_strip_activity``,
``_strip_skip_plan``, ``_strip_index_map``, ``_window_matrix_operands``.
The TPU sizing models live in ``engine/admission.py``.

The kernel has two paths, each a CUDA C++ source for sm_90a built with
nvcc at first use and loaded with ctypes by ``engine/cuda_build.py``:
``csrc/window_stream.cu`` (the register-streaming path) takes windows whose
steps are all strip-local (``STREAM_KINDS``: mix, diag, cmix), and
``csrc/window_sweep.cu`` (the tile path, shared-memory tiles) takes every
window with a row butterfly or a matrix step. What bounds each and what its
design does about that is written at the top of its file.
``encode_window`` turns a window's kernel steps into the step program both
paths interpret and picks the path (``WindowProgram.path``) by
``admission.takes_registers``, the rule the H100's admission reads too;
``CompiledCircuit`` encodes each window once at compile time and keeps the
program on the device.

``window_sweep`` launches the kernel for a CUDA float32 state or raises; a
CPU state takes ``window_sweep_reference``, the plain torch version of the
same program (same signature), which is also what the kernel is held
against on the card. Both update the planes IN PLACE: every CTA reads the
addresses it writes before writing them and tiles are disjoint, which
halves the memory of the JAX package's fresh-output default
(``_inplace_policy``:1006).
"""

from __future__ import annotations

import ctypes
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine.admission import (
    DIAG_MASK_MAX,
    HOPPER_SMEM_BYTES,
    HOPPER_SMEM_HEADER,
    STREAM_KINDS,  # noqa: F401  (the path rule's kinds, named here too)
    HopperSmemAdmission,
    hopper_tile_rows,
    takes_registers,
)
from rustqip_tpu_torch.types import MINOR_QUBITS

_C = 1 << MINOR_QUBITS  # 128


# ---------------------------------------------------------------------------
# Host helpers, ported exactly from pallas_kernels.py
# ---------------------------------------------------------------------------


def _window_qubits(n: int, seg_sizes) -> list:
    """Qubit ids of the window bits, from the segment layout."""
    h = len(seg_sizes) - 1
    m = min(n, MINOR_QUBITS)
    n_m = n - m
    wq = []
    for j in range(h):
        pos = sum(
            int(seg_sizes[k]).bit_length() - 1 for k in range(j + 1, h + 1)
        ) + (h - 1 - j)
        wq.append(n_m - 1 - pos)
    return wq


def _window_row_positions(seg_sizes) -> list:
    """Absolute row bit position of each window bit."""
    h = len(seg_sizes) - 1
    return [
        sum(int(seg_sizes[k]).bit_length() - 1 for k in range(j + 1, h + 1))
        + (h - 1 - j)
        for j in range(h)
    ]


def _specialize_groups(groups, wvals):
    """Partially evaluate diag angle groups for one strip: ``wvals`` maps
    window QUBIT ids to their 0/1 value in the strip. Monomials touching a
    0-valued window bit drop, fully-window monomials fold into the
    constant, mixed monomials whose row part was all window bits demote to
    col monomials. Shared by the encoder and ``window_strip_activity`` so
    the identity decision and the strip-skip decision cannot diverge."""
    const, row_monos, col_monos, mixed = groups
    const2 = float(const)
    rm2 = []
    for rq, c in row_monos:
        keep, dead = [], False
        for q in rq:
            v = wvals.get(q)
            if v == 0:
                dead = True
                break
            if v is None:
                keep.append(q)
        if dead:
            continue
        if keep:
            rm2.append((tuple(keep), c))
        else:
            const2 += c
    cm2 = list(col_monos)
    mx2 = []
    for rq, cq, c in mixed:
        keep, dead = [], False
        for q in rq:
            v = wvals.get(q)
            if v == 0:
                dead = True
                break
            if v is None:
                keep.append(q)
        if dead:
            continue
        if keep:
            mx2.append((tuple(keep), cq, c))
        else:
            cm2.append((cq, c))
    return const2, tuple(rm2), tuple(cm2), tuple(mx2)


def _strip_skip_plan(n, seg_sizes, steps, ns):
    """``(in_ids, out_ids, skip)``: the strips a sweep reads and writes.
    ``out_ids`` empty means the window is the identity; when skipping saves
    nothing both widen to all ``ns`` strips."""
    in_ids, out_ids = window_strip_activity(n, seg_sizes, steps)
    if not out_ids:
        return in_ids, out_ids, False
    skip = len(in_ids) + len(out_ids) < 2 * ns
    if not skip:
        in_ids = out_ids = tuple(range(ns))
    return in_ids, out_ids, skip


def window_strip_activity(n: int, seg_sizes, steps):
    """Which window strips must a sweep READ from / WRITE back to device
    memory? ``(in_ids, out_ids)`` sorted strip-index tuples: the sweep
    reads only the strips some step consumes and writes only the strips
    whose value changes (``pallas_kernels.window_strip_activity``:201)."""
    h = len(seg_sizes) - 1
    ns = 1 << h
    wq = _window_qubits(n, seg_sizes)
    pos_to_j = {p: j for j, p in enumerate(_window_row_positions(seg_sizes))}

    def wbit(i, j):
        return (i >> (h - 1 - j)) & 1

    def ctrl_dead(i, ctrl):
        return any(
            ck == "r" and pc in pos_to_j and wbit(i, pos_to_j[pc]) == 0
            for ck, pc in ctrl
        )

    modified: set = set()
    reads: set = set()

    def consume(i):
        if i not in modified:
            reads.add(i)

    for step in steps:
        kind = step[0]
        if kind in ("mix", "rmix"):
            blocks = step[1]
            newmod = set()
            for j in range(ns):
                ins = []
                for i in range(ns):
                    blk = blocks.get((j, i))
                    if blk is None:
                        continue
                    if kind == "mix":
                        if blk == 0:
                            continue
                        one = blk == 1
                    else:
                        if blk[0] == "scalar" and blk[1] == 0:
                            continue
                        one = blk[0] == "scalar" and blk[1] == 1
                    ins.append((i, one))
                if len(ins) == 1 and ins[0] == (j, True):
                    continue  # identity on this strip
                for i, _ in ins:
                    consume(i)
                newmod.add(j)
            modified |= newmod
        elif kind == "diag":
            for i in range(ns):
                wvals = {wq[j]: wbit(i, j) for j in range(h)}
                const2, rm2, cm2, mx2 = _specialize_groups(step[1], wvals)
                if not rm2 and not cm2 and not mx2 and const2 == 0.0:
                    continue
                consume(i)
                modified.add(i)
        elif kind in ("cbf", "rbf"):
            ctrl = step[3] if len(step) > 3 else ()
            for i in range(ns):
                if ctrl_dead(i, ctrl):
                    continue
                consume(i)
                modified.add(i)
        elif kind == "cmix":
            bp = step[1]
            ctrl = step[3] if len(step) > 3 else ()
            for j0 in range(ns):
                if j0 & (1 << bp):
                    continue
                j1 = j0 | (1 << bp)
                if ctrl_dead(j0, ctrl):
                    continue
                consume(j0)
                consume(j1)
                modified |= {j0, j1}
        else:  # low / lowr: per-strip matmul on every strip
            for i in range(ns):
                consume(i)
                modified.add(i)
    return tuple(sorted(reads)), tuple(sorted(modified))


def _strip_index_map(seg_sizes, sl: int, i: int):
    """Block index map for strip ``i``: factor the strip-local block
    ordinal into per-segment coordinates, then interleave the strip's
    window-bit values back in (the kernel computes the same per CTA)."""
    h = len(seg_sizes) - 1

    def index_map(r, i=i):
        d = r % sl
        rest = r // sl
        coords = []
        for s in reversed(seg_sizes[:-1]):
            coords.append(rest % s)
            rest = rest // s
        coords = coords[::-1]
        blk = 0
        for j, c in enumerate(coords):
            blk = (blk * seg_sizes[j] + c) * 2 + ((i >> (h - 1 - j)) & 1)
        return blk * sl + d, 0

    return index_map


def _window_matrix_operands(steps):
    """Split steps into body tags + matrix operand arrays: real B -> a
    ("lowr", idx) operand, complex B -> ("low", idx) with (re, im, re+im)
    operands at mats[idx:idx+3]; "rmix" block maps reference operands the
    same way, and byte-equal B^T share one operand. (``encode_window``
    hands the kernel each operand transposed back to B.)"""
    body_steps = []
    mats = []
    index_of = {}

    def add_mat(B):
        bt = np.ascontiguousarray(np.asarray(B, dtype=np.complex128).T)
        key = bt.tobytes()
        ent = index_of.get(key)
        if ent is not None:
            return ent
        mbr = np.real(bt).astype(np.float32)
        mbi = np.imag(bt).astype(np.float32)
        if not np.any(mbi):
            ent = ("lowr", len(mats))
            mats.append(mbr)
        else:
            ent = ("low", len(mats))
            mats.extend([mbr, mbi, mbr + mbi])
        index_of[key] = ent
        return ent

    for step in steps:
        if step[0] == "low":
            body_steps.append(add_mat(step[1]))
        elif step[0] == "rmix":
            blocks = {
                k: (blk if blk[0] == "scalar" else add_mat(blk[1]))
                for k, blk in step[1].items()
            }
            body_steps.append(("rmix", blocks))
        else:
            body_steps.append(step)
    return tuple(body_steps), mats


# ---------------------------------------------------------------------------
# Step program
# ---------------------------------------------------------------------------

KINDS = ("mix", "rmix", "diag", "cbf", "rbf", "cmix", "low", "lowr")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}
_REC = 8
#: Mix term types, folded as ``pallas_kernels._scalar_pair`` folds a
#: coefficient v: 1 passes the input through, a real or a pure-imaginary v
#: takes two products, any other v four (v == 0 is dropped).
T_ONE, T_REAL, T_IMAG, T_CPLX = range(4)
#: Per-strip diag entry: (int offset, float offset, nr, G, angle mode,
#: float offset of the lane parts).
_DIAG_ENT = 6
#: Matrix steps stream B through a ring of shared-memory stages in chunks
#: of 16 k x 128 lanes (csrc: KC, PART_BYTES): a chunk holds B's TF32 hi
#: and lo parts, split on the host, then, for a complex B, its imaginary
#: hi and lo parts; each part laid out as wgmma reads it.
_KC = 16
_PART = _C * _KC  # floats of one hi or lo part of a chunk
#: Stages of the B ring: a third or fourth measured no faster, and the
#: shared memory they take from L1 slows the element-wise steps.
_MAX_STAGES = 2
#: Shared memory for diag row factors or the tile path's mix table.
_SMALL_AUX = 2048
#: Most slabs (tiles x strips) one CTA holds (csrc: rq_window_sweep).
_MAX_SLABS = 16


def tf32_round(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on float32 values: round to 10 explicit
    mantissa bits, to nearest with ties away from zero (the 13 low bits of
    the result are 0)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x: np.ndarray):
    """(hi, lo) TF32 parts of float32 values, as the kernel splits its A
    operand: hi = tf32(x), lo = tf32(x - hi) (so |x - hi - lo| <= 2^-22 |x|)."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_round(x)
    return hi, tf32_round((x - hi).astype(np.float32))


def _chunk_index():
    """Gather indices (n, k) of B for every float of a chunk part, per
    chunk: [chunk kc][kk][8-lane core nc][k core kq][lane r][e]. wgmma
    reads a k8 step as 8 x 16-byte core matrices (no swizzle, K-major: the
    two k cores of a step 128 B apart, the 16 lane cores 256 B apart), and
    the k order inside a chunk is permuted as the kernel reads its A
    values (one float4 of k = 4q .. 4q + 3 per row): slot e of core kq in
    step kk is k = 16 kc + 4 e + 2 kk + kq."""
    kc, kk, nc, kq, r, e = np.meshgrid(
        np.arange(_C // _KC), np.arange(2), np.arange(_C // 8), np.arange(2),
        np.arange(8), np.arange(4), indexing="ij",
    )
    n = (8 * nc + r).reshape(_C // _KC, _PART)
    k = (_KC * kc + 4 * e + 2 * kk + kq).reshape(_C // _KC, _PART)
    return n, k


_CHUNK_N, _CHUNK_K = _chunk_index()


def b_chunks(re: np.ndarray, im: "np.ndarray | None" = None) -> np.ndarray:
    """The 8 chunks of one matrix B (row c = output lane c, as the kernel
    reads it; float32), (8, parts x 2048) float32: hi and lo of B's real
    part, then hi and lo of its imaginary part for a complex B."""
    parts = []
    for b in (re,) if im is None else (re, im):
        hi, lo = tf32_split(b)
        parts += [hi[_CHUNK_N, _CHUNK_K], lo[_CHUNK_N, _CHUNK_K]]
    return np.concatenate(parts, axis=1)


@dataclass(eq=False)
class WindowProgram:
    """One window encoded for the kernel (layout: csrc/window_sweep.cu)."""

    n: int
    seg_sizes: Tuple[int, ...]
    h: int
    bt: int
    in_mask: int
    out_mask: int
    scratch: bool
    nsteps: int
    iprog: np.ndarray
    fprog: np.ndarray
    mats: np.ndarray
    kinds: Tuple[str, ...]
    max_rbf_bit: int
    #: The tile path's B stream: every chunk of every matrix use, in the
    #: order the matrix steps consume them (``b_chunks``; float32 bits).
    bstream: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    #: Its chunks: int offset in ``iprog`` of (16-byte offset, bytes) each.
    chunk_tab: int = 0
    nchunks: int = 0
    #: The B ring: stages of ``stage_bytes`` after the tile.
    nstage: int = 0
    stage_bytes: int = 0
    #: Tiles one CTA of the tile path takes (disjoint, consecutive): up to
    #: 128 rows in all (64 with rmix), so that a matrix step's GEMM is at
    #: least one 64-row wgmma block where the window allows.
    group: int = 1
    #: "registers" (csrc/window_stream.cu) for a window of ``STREAM_KINDS``
    #: steps, "tile" (csrc/window_sweep.cu) otherwise. A register-path
    #: program with ``path="tile"`` (``dataclasses.replace``) runs the same
    #: program on the tile path: the A/B of ``chip_smoke.py``.
    path: str = "tile"
    #: Whether a diag step leaves out a diagonal's log-magnitude, which
    #: rounds to 1 in float32 (``HopperSmemAdmission.diag_mag_max``; set
    #: by ``real_apply.compile_sweeps``, counted by ``run_sweeps``).
    mag_rounded: bool = False
    _dev: Dict[str, tuple] = field(default_factory=dict, repr=False)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one tile-path CTA: header, tile (and
        rmix scratch), the small aux area and the B ring."""
        tile = (_C * 8 * self.bt * self.group << self.h) * (2 if self.scratch else 1)
        return (HOPPER_SMEM_HEADER + tile + _SMALL_AUX
                + self.nstage * self.stage_bytes)

    def tensors(self, device) -> tuple:
        """(iprog, fprog, bstream) on ``device``, uploaded once."""
        key = str(torch.device(device))
        got = self._dev.get(key)
        if got is None:
            got = (
                torch.as_tensor(self.iprog, device=device),
                torch.as_tensor(self.fprog, device=device),
                torch.as_tensor(self.bstream, device=device),
            )
            self._dev[key] = got
        return got


def _term_type(v: complex) -> int:
    """A mix coefficient's term type (``_scalar_pair``'s cases; v != 0)."""
    if v == 1:
        return T_ONE
    if v.imag == 0:
        return T_REAL
    if v.real == 0:
        return T_IMAG
    return T_CPLX


def _row_class(coeffs) -> int:
    """0 when every term of a mix output is one or real, 1 when every term
    is imaginary, 2 otherwise (the register path's loop per class)."""
    types = {_term_type(v) for v in coeffs}
    if types <= {T_ONE, T_REAL}:
        return 0
    return 1 if types == {T_IMAG} else 2


def _mix_butterflies(blocks, ns: int):
    """Factor a mix's coefficient matrix M (output strip j, input strip i)
    into one 2 x 2 matrix per window-index bit, M[j, i] = prod_b
    m_b[j_b, i_b]: the factors that are not the identity as [(bit, m_b)],
    the matrix's scale folded into the first; None when M is no such
    product (or h = 0). The register path applies them as butterflies."""
    h = ns.bit_length() - 1
    if h == 0:
        return None
    M = np.zeros((ns, ns), dtype=np.complex128)
    for (j, i), v in blocks.items():
        M[j, i] = complex(v)
    j0, i0 = np.unravel_index(np.argmax(np.abs(M)), M.shape)
    scale = M[j0, i0]
    if scale == 0:
        return None
    facs = []
    for b in range(h):
        f = np.empty((2, 2), dtype=np.complex128)
        for x in range(2):
            for y in range(2):
                jj = (j0 & ~(1 << b)) | (x << b)
                ii = (i0 & ~(1 << b)) | (y << b)
                f[x, y] = M[jj, ii] / scale
        facs.append(f)
    idx = np.arange(ns)
    R = np.full((ns, ns), scale)
    for b, f in enumerate(facs):
        R = R * f[(idx[:, None] >> b) & 1, (idx[None, :] >> b) & 1]
    if np.abs(R - M).max() > 1e-10 * np.abs(M).max():
        return None
    out = [(b, f) for b, f in enumerate(facs) if not np.allclose(f, np.eye(2), rtol=0, atol=1e-15)]
    if not out:
        out = [(0, np.eye(2))]
    out[0] = (out[0][0], out[0][1] * scale)
    return out


def encode_window(n: int, seg_sizes, ksteps) -> WindowProgram:
    """Encode a window's kernel steps (``real_apply.window_ksteps``) into
    the step program the kernel and ``window_sweep_reference`` interpret.
    Per-step active strip masks follow the TPU body's live-strip
    bookkeeping exactly (which strips each step touches, ctrl-dead strips
    skipped, diag specialized per strip). A window of ``STREAM_KINDS``
    steps takes the register-streaming path, any other the tile path."""
    seg_sizes = tuple(int(s) for s in seg_sizes)
    h = len(seg_sizes) - 1
    ns = 1 << h
    m = min(n, MINOR_QUBITS)
    if n - m > 32:
        raise ValueError("window kernel row masks are 32-bit (n <= 39)")
    in_ids, out_ids, _ = _strip_skip_plan(n, seg_sizes, ksteps, ns)
    body_steps, mats = _window_matrix_operands(ksteps)
    wq = _window_qubits(n, seg_sizes)
    pos_to_j = {p: j for j, p in enumerate(_window_row_positions(seg_sizes))}
    n_m = n - m

    def ctrl_dead(i, ctrl):
        return any(
            ck == "r"
            and pc in pos_to_j
            and ((i >> (h - 1 - pos_to_j[pc])) & 1) == 0
            for ck, pc in ctrl
        )

    def ctrl_masks(ctrl):
        rm = cm = 0
        for ck, pc in ctrl:
            if ck == "r":
                rm |= 1 << pc
            else:
                cm |= 1 << pc
        return rm, cm

    def rowmask(qs):
        return sum(1 << (n_m - 1 - q) for q in qs)

    def colmask(qs):
        return sum(1 << (n - 1 - q) for q in qs)

    recs = []
    ints: list = []
    floats: list = []
    cur = set(in_ids)
    max_rbf = -1
    uses: list = []  # (operand index, complex) of each matrix use, in order

    def add_complex(v) -> int:
        off = len(floats)
        floats.extend([complex(v).real, complex(v).imag])
        return off

    def mask_of(ids) -> int:
        return sum(1 << i for i in ids)

    lanes = np.arange(_C)

    def lane_angles(terms):
        """Angle over the 128 lanes of (col qubits, coefficient) terms."""
        ang = np.zeros(_C)
        for cq, c in terms:
            cm = colmask(cq)
            ang += c * ((lanes & cm) == cm)
        return ang

    lane_parts: dict = {}  # equal lane parts of a window are stored once

    def diag_entry(sg, angle_mode):
        """One strip's separable diag factors (``diag_factors``:406):
        the constant and row monomials (angles the kernel sums per row),
        the lane monomials folded into one lane part, and the mixed
        monomials grouped by row support, one row mask + lane part each.
        A part is cos and sin (factor mode) or the angle (angle mode). The
        lane parts are shared by every entry whose parts are equal (strips
        that differ only in their row monomials: QFT's) and start on a
        16-byte boundary (vector loads)."""
        const2, rm2, cm2, mx2 = sg
        by_row: dict = {}
        for rq, cq, c in mx2:
            by_row.setdefault(rq, []).append((cq, c))
        parts = [lane_angles(cm2)] + [lane_angles(t) for t in by_row.values()]
        data = np.concatenate([
            ang if angle_mode else np.concatenate([np.cos(ang), np.sin(ang)])
            for ang in parts
        ]).astype(np.float32)
        lo = lane_parts.get(data.tobytes())
        if lo is None:
            floats.extend([0.0] * (-len(floats) % 4))
            lo = lane_parts[data.tobytes()] = len(floats)
            floats.extend(data.tolist())
        ent = [len(ints), len(floats), len(rm2), len(by_row), int(angle_mode), lo]
        ints.extend(rowmask(rq) for rq, _ in rm2)
        ints.extend(rowmask(rq) for rq in by_row)
        floats.append(const2)
        floats.extend(c for _, c in rm2)
        return ent

    for step in body_steps:
        kind = step[0]
        rec = [_KIND_CODE[kind], 0, 0, 0, 0, 0, 0, 0]
        if kind == "diag":
            per = len(ints)
            ints.extend([0] * (_DIAG_ENT * ns))
            active = 0
            entries: dict = {}  # strips with equal specialized groups share
            for i in sorted(cur):
                wvals = {wq[j]: (i >> (h - 1 - j)) & 1 for j in range(h)}
                sg = _specialize_groups(step[1], wvals)
                const2, rm2, cm2, mx2 = sg
                if not rm2 and not cm2 and not mx2 and const2 == 0.0:
                    continue  # identity on this strip
                active |= 1 << i
                if sg not in entries:
                    groups = len({rq for rq, _cq, _c in mx2})
                    entries[sg] = diag_entry(sg, groups > DIAG_MASK_MAX)
                ints[per + _DIAG_ENT * i : per + _DIAG_ENT * (i + 1)] = (
                    entries[sg]
                )
            ents = [ints[per + _DIAG_ENT * i : per + _DIAG_ENT * (i + 1)]
                    for i in range(ns) if active >> i & 1]
            angle = any(e[4] for e in ents)
            rec[1:4] = [active, per, int(angle)]
            los = sorted({e[5] for e in ents})
            if ents and not angle and all(e[3] == 0 for e in ents) and len(los) <= 2:
                # every strip's factor is its row factor times one of two
                # lane parts (the register path loads both once)
                second = sum(1 << i for i in range(ns) if active >> i & 1
                             and ints[per + _DIAG_ENT * i + 5] == los[-1] != los[0])
                rec[4:8] = [1, los[0], los[-1], second]
        elif kind in ("cbf", "rbf", "cmix"):
            p, coeffs = step[1], step[2]
            ctrl = step[3] if len(step) > 3 else ()
            if kind == "cmix":
                pairs = [
                    j0 for j0 in range(ns)
                    if not j0 & (1 << p) and not ctrl_dead(j0, ctrl)
                ]
                active = mask_of(pairs)
                for j0 in pairs:
                    cur |= {j0, j0 | (1 << p)}
            else:
                active = mask_of(i for i in cur if not ctrl_dead(i, ctrl))
                if kind == "rbf":
                    max_rbf = max(max_rbf, p)
            rm, cm = ctrl_masks(ctrl)
            foff = len(floats)
            for v in coeffs:
                add_complex(v)
            rec[1:6] = [active, p, rm, cm, foff]
        elif kind in ("low", "lowr"):
            rec[1:3] = [mask_of(cur), step[1]]
            uses.append((step[1], kind == "low"))
        elif kind == "rmix":
            blocks = step[1]
            terms = len(ints)
            ints.extend([0] * (2 * ns * ns))
            active = 0
            distinct: dict = {}  # matrix operand -> complex, first use first
            for jw in range(ns):
                ent = []
                for iw in range(ns):
                    blk = blocks.get((jw, iw))
                    if blk is None or (blk[0] == "scalar" and blk[1] == 0):
                        continue
                    ent.append((iw, blk))
                if (
                    len(ent) == 1
                    and ent[0][0] == jw
                    and ent[0][1][0] == "scalar"
                    and ent[0][1][1] == 1
                ):
                    continue  # identity on this strip
                active |= 1 << jw
                for iw, blk in ent:
                    if blk[0] == "scalar":
                        typ, pay = 1, add_complex(blk[1])
                    else:
                        typ, pay = (2 if blk[0] == "lowr" else 3), blk[1]
                        distinct.setdefault(pay, typ == 3)
                    ints[terms + 2 * (jw * ns + iw)] = typ
                    ints[terms + 2 * (jw * ns + iw) + 1] = pay
            cur |= {j for j in range(ns) if active >> j & 1}
            mlist = len(ints)
            for pay, cplx in distinct.items():
                ints.extend([pay, int(cplx)])
            three = any(distinct.values())
            rec[1:6] = [active, terms, mlist, len(distinct), int(three)]
            uses.extend(distinct.items())
        else:  # mix: {(j, i): complex}
            blocks = step[1]
            ints.extend([0] * (-len(ints) % 4))  # entries load as int4
            per = len(ints)
            ints.extend([0] * (4 * ns))
            active = 0
            for j in range(ns):
                ent = [
                    (i, complex(blocks[(j, i)]))
                    for i in range(ns)
                    if blocks.get((j, i)) not in (None, 0)
                ]
                if len(ent) == 1 and ent[0] == (j, 1):
                    continue  # identity on this strip
                active |= 1 << j
                # (input mask, 2 type bits per input, float offset of the
                # coefficients in input order (8-byte aligned), row class)
                floats.extend([0.0] * (len(floats) % 2))
                mask = types = 0
                cf = len(floats)
                for i, v in ent:
                    mask |= 1 << i
                    types |= _term_type(v) << (2 * i)
                    floats.extend([v.real, v.imag])
                ints[per + 4 * j : per + 4 * j + 4] = [
                    mask, types, cf, _row_class(v for _, v in ent)]
            cur |= {j for j in range(ns) if active >> j & 1}
            rec[1:3] = [active, per]
            bfly = _mix_butterflies(blocks, ns) if active else None
            if bfly:
                rec[3:6] = [len(bfly), len(ints), len(floats)]
                ints.extend(b for b, _ in bfly)
                for _, f in bfly:
                    for v in f.reshape(-1):
                        add_complex(v)
        recs.append(rec)

    base = len(recs) * _REC
    # Offsets into ints were taken before the records; shift them past.
    for rec in recs:
        kind = KINDS[rec[0]]
        if kind in ("mix", "rmix", "diag"):
            rec[2] += base
        if kind == "rmix" or (kind == "mix" and rec[3]):
            rec[3 if kind == "rmix" else 4] += base
        if kind == "diag":
            per = rec[2] - base
            for i in range(ns):
                if rec[1] >> i & 1:
                    ints[per + _DIAG_ENT * i] += base
    has_rmix = any(s[0] == "rmix" for s in body_steps)
    bt = hopper_tile_rows(h, has_rmix, seg_sizes[-1])
    # Tiles per CTA: consecutive tiles up to the rows one tile of the
    # budget holds (hopper_tile_rows), so small tiles (8 rows a strip) meet
    # in one 64- or 128-row GEMM.
    n_tiles = int(np.prod(seg_sizes)) // bt
    group = 1
    while (2 * group * ns * bt <= (64 if has_rmix else 128)
           and 2 * group * ns <= _MAX_SLABS and n_tiles % (2 * group) == 0):
        group *= 2
    # The B stream and its chunk table (16-byte offset, bytes per chunk).
    mats_b = [m.T.astype(np.float32) for m in mats]
    chunks = [
        b_chunks(mats_b[idx], mats_b[idx + 1] if cplx else None)
        for idx, cplx in uses
    ]
    chunk_tab = base + len(ints)
    off = 0
    for ch in chunks:
        for _ in range(_C // _KC):
            ints.extend([off // 4, 4 * ch.shape[1]])
            off += ch.shape[1]
    nchunks = len(chunks) * (_C // _KC)
    bstream = (
        np.ascontiguousarray(np.concatenate([c.reshape(-1) for c in chunks]))
        if chunks else np.zeros(4, dtype=np.float32)
    )
    iprog = np.asarray(
        [v for rec in recs for v in rec] + ints, dtype=np.int64
    )
    # masks are unsigned 32-bit; store their bit patterns as int32
    iprog = iprog.astype(np.uint32).view(np.int32)
    fprog = np.asarray(floats + [0.0], dtype=np.float32)
    # The kernel reads B row-major (row c = output lane c over input lanes
    # k); _window_matrix_operands keeps the reference's B^T.
    mats_arr = (
        np.stack([m.T for m in mats]).astype(np.float32)
        if mats
        else np.zeros((1, _C, _C), dtype=np.float32)
    )
    kinds = {KINDS[r[0]] for r in recs}
    stage_bytes = max((4 * c.shape[1] for c in chunks), default=0)
    prog = WindowProgram(
        n=n,
        seg_sizes=seg_sizes,
        h=h,
        bt=bt,
        in_mask=mask_of(in_ids),
        out_mask=mask_of(out_ids),
        scratch=has_rmix,
        nsteps=len(recs),
        iprog=np.ascontiguousarray(iprog),
        fprog=fprog,
        mats=np.ascontiguousarray(mats_arr),
        kinds=tuple(sorted(kinds)),
        max_rbf_bit=max_rbf,
        bstream=bstream,
        chunk_tab=chunk_tab,
        nchunks=nchunks,
        stage_bytes=stage_bytes,
        group=group,
        path="registers" if takes_registers(kinds) else "tile",
    )
    if nchunks:
        room = (HOPPER_SMEM_BYTES - prog.smem_bytes) // stage_bytes
        prog.nstage = min(_MAX_STAGES, nchunks, room)
        if prog.nstage < 1:
            raise ValueError("window leaves no shared memory for a B stage")
    if prog.smem_bytes > HOPPER_SMEM_BYTES:
        raise ValueError(
            f"window needs {prog.smem_bytes} B of shared memory "
            f"(> {HOPPER_SMEM_BYTES})"
        )
    return prog


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _check_planes(n: int, xr: torch.Tensor, xi: torch.Tensor) -> None:
    """The planes both versions take, on every device: contiguous float32
    (R, 128) planes."""
    R = 1 << (n - MINOR_QUBITS)
    for x in (xr, xi):
        if x.dtype != torch.float32:
            raise TypeError(f"window_sweep takes float32 planes, got {x.dtype}")
        if tuple(x.shape) != (R, _C):
            raise ValueError(
                f"window_sweep takes ({R}, {_C}) planes, got {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError("window_sweep takes contiguous planes")


def _strip_views(prog: WindowProgram, x: torch.Tensor):
    """Views of the 2^h strips of an (R, C) plane (strided in memory)."""
    h = prog.h
    full = []
    for s in prog.seg_sizes[:-1]:
        full += [s, 2]
    full += [prog.seg_sizes[-1], x.shape[-1]]
    xv = x.view(full)
    out = []
    for i in range(1 << h):
        idx = []
        for j in range(h):
            idx += [slice(None), (i >> (h - 1 - j)) & 1]
        out.append(xv[tuple(idx)])
    return out


def _strip_rows(prog: WindowProgram, device) -> list:
    """Absolute row index of every strip row, per strip (int64)."""
    rows = torch.arange(
        int(np.prod(prog.seg_sizes)) << prog.h, device=device
    ).view(-1, 1)
    return [v.reshape(-1) for v in _strip_views(prog, rows)]


def window_sweep_reference(
    n: int, xr, xi, seg_sizes, ksteps, prog: "WindowProgram | None" = None
):
    """The window kernel's semantics in plain torch on whole strips: the
    same step program, interpreted step by step; updates ``xr``/``xi`` in
    place and returns them."""
    if prog is None:
        prog = encode_window(n, seg_sizes, ksteps)
    if not prog.out_mask:
        return xr, xi
    h, ns = prog.h, 1 << prog.h
    ip = prog.iprog.view(np.uint32).astype(np.int64)
    fp = prog.fprog
    mats = torch.as_tensor(prog.mats, dtype=xr.dtype, device=xr.device)
    vr, vi = _strip_views(prog, xr), _strip_views(prog, xi)
    rows = _strip_rows(prog, xr.device)
    cols = torch.arange(_C, device=xr.device)
    cur = {
        i: (vr[i].reshape(-1, _C).clone(), vi[i].reshape(-1, _C).clone())
        for i in range(ns)
        if prog.in_mask >> i & 1
    }

    def bits(i):
        return [j for j in range(ns) if i >> j & 1]

    def cplx(off):
        return float(fp[off]), float(fp[off + 1])

    def ctrl_mask(i, rm, cm):
        return (((rows[i] & rm) == rm)[:, None]) & ((cols & cm) == cm)[None, :]

    def mat_apply(x, y, typ, idx):
        """(x + i y) @ B^T, B = mats[idx] (+ i mats[idx + 1]): two real
        products, or three by Karatsuba with the re + im operand, as the
        kernel forms them."""
        if typ == 2:
            return x @ mats[idx].T, y @ mats[idx].T
        rr = x @ mats[idx].T
        ii = y @ mats[idx + 1].T
        m = (x + y) @ mats[idx + 2].T
        return rr - ii, m - rr - ii

    for s in range(prog.nsteps):
        rec = ip[s * _REC : (s + 1) * _REC]
        kind, active = KINDS[rec[0]], int(rec[1])
        if kind == "mix":
            new = {}
            for j in bits(active):
                mask, types, cf, _ = (int(v) for v in ip[rec[2] + 4 * j : rec[2] + 4 * j + 4])
                ar = xr.new_zeros((rows[j].numel(), _C))
                ai = torch.zeros_like(ar)
                for i in bits(mask):
                    (x, y), (cr, ci) = cur[i], cplx(cf)
                    cf += 2
                    typ = types >> (2 * i) & 3
                    if typ == T_ONE:
                        tr, ti = x, y
                    elif typ == T_REAL:
                        tr, ti = cr * x, cr * y
                    elif typ == T_IMAG:
                        tr, ti = -(ci * y), ci * x
                    else:
                        tr, ti = cr * x - ci * y, cr * y + ci * x
                    ar, ai = ar + tr, ai + ti
                new[j] = (ar, ai)
            cur.update(new)
        elif kind == "rmix":
            new = {}
            for j in bits(active):
                ar = xr.new_zeros((rows[j].numel(), _C))
                ai = torch.zeros_like(ar)
                for i in range(ns):
                    typ = int(ip[rec[2] + 2 * (j * ns + i)])
                    pay = int(ip[rec[2] + 2 * (j * ns + i) + 1])
                    if not typ:
                        continue
                    x, y = cur[i]
                    if typ == 1:
                        cr, ci = cplx(pay)
                        ar, ai = ar + (cr * x - ci * y), ai + (cr * y + ci * x)
                    else:
                        tr, ti = mat_apply(x, y, typ, pay)
                        ar, ai = ar + tr, ai + ti
                new[j] = (ar, ai)
            cur.update(new)
        elif kind == "diag":
            for i in bits(active):
                io, fo, nr, G, angle_mode, lo = (
                    int(v) for v in ip[rec[2] + _DIAG_ENT * i : rec[2] + _DIAG_ENT * (i + 1)]
                )
                ang = torch.full(
                    (rows[i].numel(),), float(fp[fo]),
                    dtype=torch.float32, device=xr.device,
                )
                for k in range(nr):
                    on = (rows[i] & int(ip[io + k])) == int(ip[io + k])
                    ang = ang + on.to(torch.float32) * float(fp[fo + 1 + k])
                gmasks = [int(v) for v in ip[io + nr : io + nr + G]]
                width = _C if angle_mode else 2 * _C
                lane = [
                    torch.as_tensor(fp[lo + width * k : lo + width * (k + 1)], device=xr.device)
                    for k in range(1 + G)
                ]
                ons = [((rows[i] & gm) == gm)[:, None] for gm in gmasks]
                if angle_mode:
                    a = ang[:, None] + lane[0][None, :]
                    for on, v in zip(ons, lane[1:]):
                        a = a + on.to(torch.float32) * v[None, :]
                    pr, pi = torch.cos(a), torch.sin(a)
                else:
                    rc, rs = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
                    lr, li = lane[0][None, :_C], lane[0][None, _C:]
                    pr, pi = rc * lr - rs * li, rc * li + rs * lr
                    for on, v in zip(ons, lane[1:]):
                        gr, gi = v[None, :_C], v[None, _C:]
                        pr, pi = (
                            torch.where(on, pr * gr - pi * gi, pr),
                            torch.where(on, pr * gi + pi * gr, pi),
                        )
                pr, pi = pr.to(xr.dtype), pi.to(xr.dtype)
                x, y = cur[i]
                cur[i] = (x * pr - y * pi, x * pi + y * pr)
        elif kind in ("cbf", "rbf", "cmix"):
            p, rm, cm, foff = (int(v) for v in rec[2:6])
            a, b, c, d = (cplx(foff + 2 * k) for k in range(4))

            def pair(x0r, x0i, x1r, x1i, on):
                y0r = a[0] * x0r - a[1] * x0i + b[0] * x1r - b[1] * x1i
                y0i = a[0] * x0i + a[1] * x0r + b[0] * x1i + b[1] * x1r
                y1r = c[0] * x0r - c[1] * x0i + d[0] * x1r - d[1] * x1i
                y1i = c[0] * x0i + c[1] * x0r + d[0] * x1i + d[1] * x1r
                return (
                    torch.where(on, y0r, x0r), torch.where(on, y0i, x0i),
                    torch.where(on, y1r, x1r), torch.where(on, y1i, x1i),
                )

            for i in bits(active):
                on = ctrl_mask(i, rm, cm)
                if kind == "cmix":
                    j1 = i | (1 << p)
                    (x0r, x0i), (x1r, x1i) = cur[i], cur[j1]
                    y = pair(x0r, x0i, x1r, x1i, on)
                    cur[i], cur[j1] = (y[0], y[1]), (y[2], y[3])
                    continue
                x, y = cur[i]
                s_ = 1 << p
                if kind == "cbf":
                    shp = (x.shape[0], _C // (2 * s_), 2, s_)
                    sel = (slice(None), slice(None))
                else:
                    shp = (x.shape[0] // (2 * s_), 2, s_, _C)
                    sel = (slice(None),)
                xv, yv, onv = x.view(shp), y.view(shp), on.expand_as(x).reshape(shp)
                lo, hi = sel + (0,), sel + (1,)
                out = pair(xv[lo], yv[lo], xv[hi], yv[hi], onv[lo])
                nx, ny = torch.empty_like(xv), torch.empty_like(yv)
                nx[lo], ny[lo], nx[hi], ny[hi] = out
                cur[i] = (nx.view_as(x), ny.view_as(y))
        else:  # low / lowr
            typ = 3 if kind == "low" else 2
            for i in bits(active):
                cur[i] = mat_apply(*cur[i], typ, int(rec[2]))
    for i in bits(prog.out_mask):
        vr[i].copy_(cur[i][0].view_as(vr[i]))
        vi[i].copy_(cur[i][1].view_as(vi[i]))
    return xr, xi


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

#: The entry points of the two paths and their argument types: the tile
#: path's (csrc/window_sweep.cu) and the register path's
#: (csrc/window_stream.cu).
TILE_ENTRY = ("window_sweep", "rq_window_sweep")
TILE_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
)
STREAM_ENTRY = ("window_stream", "rq_window_stream")
STREAM_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
#: ``cuda_build.LAUNCHES`` keys of the step kinds, by kind.
_KIND_KEYS = {k: cuda_build.KIND_PREFIX + k for k in KINDS}


def window_sweep(
    n: int, xr, xi, seg_sizes, ksteps, prog: "WindowProgram | None" = None,
    out=None,
):
    """Run one strip window over float32 (R, 128) planes, in place, or,
    with ``out=(yr, yi)``, from (xr, xi) into fresh planes of the same
    shape (a tile-path window that writes every strip; the input is left
    alone).

    A CUDA state launches the Hopper kernel of the program's path (and
    counts the launch) or raises; a CPU state takes
    ``window_sweep_reference``. ``prog`` is the window's encoded step
    program (``encode_window``); pass it to skip re-encoding (compiled
    circuits do)."""
    _check_planes(n, xr, xi)
    if prog is None:
        prog = encode_window(n, seg_sizes, ksteps)
    if out is not None:
        _check_planes(n, *out)
        if prog.out_mask != (1 << (1 << prog.h)) - 1 or prog.path != "tile":
            raise ValueError("window_sweep: out= needs a tile-path window that writes every strip")
    if not cuda_build.on_card("window_sweep", xr, xi, *(out or ())):
        if out is not None:
            out[0].copy_(xr)
            out[1].copy_(xi)
            xr, xi = out
        return window_sweep_reference(n, xr, xi, seg_sizes, ksteps, prog=prog)
    if not prog.out_mask:
        return xr, xi
    yr, yi = (xr, xi) if out is None else out
    stream = prog.path == "registers"
    srows = xr.shape[0] >> prog.h
    # A tile under the tile path's smallest computes right but is not worth
    # a launch, so the H100's admission plans none: one comes only from a
    # plan of another admission, unless it holds a whole strip of a state
    # that small (c64_low_matmul under 8 rows).
    if not stream and prog.bt < min(HopperSmemAdmission.MIN_TILE_ROWS, srows):
        raise ValueError(
            f"a {prog.bt}-row tile is under the tile path's "
            f"{HopperSmemAdmission.MIN_TILE_ROWS} (plan with HopperSmemAdmission)"
        )
    if not stream and (1 << (prog.max_rbf_bit + 1)) > prog.bt:
        raise ValueError(
            f"rbf bit {prog.max_rbf_bit} does not fit a {prog.bt}-row tile "
            "(plan with HopperSmemAdmission)"
        )
    iprog, fprog, bstream = prog.tensors(xr.device)
    kinds = [_KIND_KEYS[k] for k in prog.kinds]
    if stream:
        pos = _window_row_positions(prog.seg_sizes)
        cuda_build.launch(
            "window_sweep", cuda_build.function(*STREAM_ENTRY, STREAM_ARGTYPES), xr.device,
            xr.data_ptr(), xi.data_ptr(), iprog.data_ptr(), fprog.data_ptr(),
            prog.h, prog.nsteps, prog.in_mask, prog.out_mask,
            *(pos + [0] * (4 - len(pos))), srows, also=["window_stream"] + kinds,
        )
    else:
        seg = list(prog.seg_sizes) + [1] * (5 - len(prog.seg_sizes))
        cuda_build.launch(
            "window_sweep", cuda_build.function(*TILE_ENTRY, TILE_ARGTYPES), xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            iprog.data_ptr(), fprog.data_ptr(), bstream.data_ptr(), prog.h,
            prog.nsteps, prog.bt, prog.group, prog.in_mask, prog.out_mask,
            int(prog.scratch), prog.nstage, prog.stage_bytes, prog.chunk_tab,
            prog.nchunks, *seg, srows // (prog.bt * prog.group), also=kinds,
        )
    return yr, yi


#: One-"low"-step programs of ``c64_low_matmul``, by (rows, matrix bytes):
#: plans hand it the same B on every run, so each is encoded and uploaded
#: once, not per call.
_LOW_PROGRAMS: Dict[tuple, WindowProgram] = {}
_LOW_PROGRAMS_MAX = 256


def _low_program(R: int, B: np.ndarray) -> WindowProgram:
    B = np.ascontiguousarray(B)
    key = (R, B.dtype.str, B.shape, hashlib.blake2b(B.tobytes(), digest_size=16).digest())
    prog = _LOW_PROGRAMS.get(key)
    if prog is None:
        if len(_LOW_PROGRAMS) >= _LOW_PROGRAMS_MAX:
            _LOW_PROGRAMS.clear()
        n = (R * _C).bit_length() - 1
        prog = _LOW_PROGRAMS[key] = encode_window(n, (R,), [("low", B)])
    return prog


def c64_low_matmul(xr, xi, B: np.ndarray, kernel: bool = True):
    """(xr + i xi) @ B.T for a C x C complex block matrix B on (R, C)
    planes: a one-"low"-step window of the same kernel for CUDA float32
    (as ``pallas_kernels.c64_low_matmul`` takes its kernel on the TPU),
    plain matmuls otherwise or when ``kernel`` is false. Like the JAX
    function it leaves its inputs alone (callers such as a wide controlled
    op read them again): the kernel reads them and writes fresh planes."""
    if kernel and xr.is_cuda and xr.dtype == torch.float32 and xr.shape[1] == _C:
        prog = _low_program(xr.shape[0], B)
        out = (torch.empty_like(xr), torch.empty_like(xi))
        return window_sweep(prog.n, xr.contiguous(), xi.contiguous(), prog.seg_sizes,
                            [("low", B)], prog=prog, out=out)
    bt = np.ascontiguousarray(np.asarray(B).T)
    br = torch.as_tensor(np.real(bt), dtype=xr.dtype, device=xr.device)
    bi = torch.as_tensor(np.imag(bt), dtype=xr.dtype, device=xr.device)
    return xr @ br - xi @ bi, xr @ bi + xi @ br

