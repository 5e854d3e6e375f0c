"""The strip-window sweep: host planning helpers, the step-program encoder,
the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``rustqip_tpu/engine/pallas_kernels.py`` (the JAX package's one
TPU kernel: ``window_sweep``:1155 / ``_window_sweep_pipelined``:1029 with
body ``_window_kernel_body``:308, and ``c64_low_matmul``:1328). The host
side is ported exactly: ``_specialize_groups``, ``window_strip_activity``,
``_strip_skip_plan``, ``_strip_index_map``, ``_window_matrix_operands``.
The TPU sizing models live in ``engine/admission.py``.

The kernel itself is ``rustqip_tpu_torch/csrc/window_sweep.cu`` (CUDA C++
for sm_90a, built with nvcc at first use and loaded with ctypes). What
bounds it and what its design does about that is written at the top of
that file. ``encode_window`` turns a window's kernel steps into the step
program the kernel interprets; ``CompiledCircuit`` encodes each window once
at compile time and keeps the program on the device.

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
import os
import shutil
import subprocess
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine.admission import hopper_tile_rows
from rustqip_tpu_torch.types import MINOR_QUBITS

_C = 1 << MINOR_QUBITS  # 128

#: Kernel launches, counted by ``window_sweep`` where it launches and
#: nowhere else (``reset_launch_counts`` zeroes both counters).
LAUNCHES: Counter = Counter()
#: Launches by step kind contained in the launched program.
KIND_LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    KIND_LAUNCHES.clear()


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
    same way, and byte-equal B^T share one operand. (The CUDA kernel uses
    the 4-product form, so it reads re and im and never the re+im
    operand; the layout stays the reference's.)"""
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
    _dev: Dict[str, tuple] = field(default_factory=dict, repr=False)

    def tensors(self, device) -> tuple:
        """(iprog, fprog, mats) on ``device``, uploaded once."""
        key = str(torch.device(device))
        got = self._dev.get(key)
        if got is None:
            got = (
                torch.as_tensor(self.iprog, device=device),
                torch.as_tensor(self.fprog, device=device),
                torch.as_tensor(self.mats, device=device),
            )
            self._dev[key] = got
        return got


def encode_window(n: int, seg_sizes, ksteps) -> WindowProgram:
    """Encode a window's kernel steps (``real_apply.window_ksteps``) into
    the step program the kernel and ``window_sweep_reference`` interpret.
    Per-step active strip masks follow the TPU body's live-strip
    bookkeeping exactly (which strips each step touches, ctrl-dead strips
    skipped, diag specialized per strip)."""
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

    def add_complex(v) -> int:
        off = len(floats)
        floats.extend([complex(v).real, complex(v).imag])
        return off

    def mask_of(ids) -> int:
        return sum(1 << i for i in ids)

    for step in body_steps:
        kind = step[0]
        rec = [_KIND_CODE[kind], 0, 0, 0, 0, 0, 0, 0]
        if kind == "diag":
            per = len(ints)
            ints.extend([0] * (3 * ns))
            consts = len(floats)
            floats.extend([0.0] * ns)
            active = 0
            for i in sorted(cur):
                wvals = {wq[j]: (i >> (h - 1 - j)) & 1 for j in range(h)}
                const2, rm2, cm2, mx2 = _specialize_groups(step[1], wvals)
                if not rm2 and not cm2 and not mx2 and const2 == 0.0:
                    continue  # identity on this strip
                active |= 1 << i
                monos = (
                    [(rowmask(rq), 0, c) for rq, c in rm2]
                    + [(0, colmask(cq), c) for cq, c in cm2]
                    + [(rowmask(rq), colmask(cq), c) for rq, cq, c in mx2]
                )
                ints[per + 3 * i : per + 3 * i + 3] = [
                    len(ints), len(floats), len(monos)
                ]
                for rmk, cmk, c in monos:
                    ints.extend([rmk, cmk])
                for *_, c in monos:
                    floats.append(c)
                floats[consts + i] = const2
            rec[1:4] = [active, per, consts]
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
        elif kind == "rmix":
            blocks = step[1]
            terms = len(ints)
            ints.extend([0] * (2 * ns * ns))
            active = 0
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
                    ints[terms + 2 * (jw * ns + iw)] = typ
                    ints[terms + 2 * (jw * ns + iw) + 1] = pay
            cur |= {j for j in range(ns) if active >> j & 1}
            rec[1:3] = [active, terms]
        else:  # mix: {(j, i): complex}
            blocks = step[1]
            nzoff = len(ints)
            ints.extend([0] * ns)
            coef = len(floats)
            floats.extend([0.0] * (2 * ns * ns))
            active = 0
            for j in range(ns):
                ent = [
                    (i, blocks[(j, i)])
                    for i in range(ns)
                    if blocks.get((j, i)) not in (None, 0)
                ]
                if len(ent) == 1 and ent[0] == (j, 1):
                    continue  # identity on this strip
                active |= 1 << j
                for i, v in ent:
                    ints[nzoff + j] |= 1 << i
                    floats[coef + 2 * (j * ns + i)] = complex(v).real
                    floats[coef + 2 * (j * ns + i) + 1] = complex(v).imag
            cur |= {j for j in range(ns) if active >> j & 1}
            rec[1:4] = [active, nzoff, coef]
        recs.append(rec)

    base = len(recs) * _REC
    # Offsets into ints were taken before the records; shift them past.
    for rec in recs:
        kind = KINDS[rec[0]]
        if kind in ("mix", "rmix", "diag"):
            rec[2] += base
    for rec in recs:
        if KINDS[rec[0]] == "diag":
            per = rec[2] - base
            for i in range(ns):
                if rec[1] >> i & 1:
                    ints[per + 3 * i] += base
    iprog = np.asarray(
        [v for rec in recs for v in rec] + ints, dtype=np.int64
    )
    # masks are unsigned 32-bit; store their bit patterns as int32
    iprog = iprog.astype(np.uint32).view(np.int32)
    fprog = np.asarray(floats + [0.0], dtype=np.float32)
    mats_arr = (
        np.stack(mats).astype(np.float32)
        if mats
        else np.zeros((1, _C, _C), dtype=np.float32)
    )
    has_rmix = any(s[0] == "rmix" for s in body_steps)
    return WindowProgram(
        n=n,
        seg_sizes=seg_sizes,
        h=h,
        bt=hopper_tile_rows(h, has_rmix, seg_sizes[-1]),
        in_mask=mask_of(in_ids),
        out_mask=mask_of(out_ids),
        scratch=has_rmix,
        nsteps=len(recs),
        iprog=np.ascontiguousarray(iprog),
        fprog=fprog,
        mats=np.ascontiguousarray(mats_arr),
        kinds=tuple(sorted({KINDS[r[0]] for r in recs})),
        max_rbf_bit=max_rbf,
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _check_planes(n: int, xr: torch.Tensor, xi: torch.Tensor) -> None:
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
    if xr.device != xi.device:
        raise ValueError("window_sweep planes must share one device")


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
        if typ == 2:
            return x @ mats[idx], y @ mats[idx]
        mr, mi = mats[idx], mats[idx + 1]
        return x @ mr - y @ mi, x @ mi + y @ mr

    for s in range(prog.nsteps):
        rec = ip[s * _REC : (s + 1) * _REC]
        kind, active = KINDS[rec[0]], int(rec[1])
        if kind in ("mix", "rmix"):
            new = {}
            for j in bits(active):
                ar = xr.new_zeros((rows[j].numel(), _C))
                ai = torch.zeros_like(ar)
                for i in range(ns):
                    if kind == "mix":
                        if not ip[rec[2] + j] >> i & 1:
                            continue
                        typ, pay = 1, rec[3] + 2 * (j * ns + i)
                    else:
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
                mi, mf, cnt = (int(v) for v in ip[rec[2] + 3 * i : rec[2] + 3 * i + 3])
                ang = torch.full(
                    (rows[i].numel(), _C), float(fp[rec[3] + i]),
                    dtype=torch.float32, device=xr.device,
                )
                for k in range(cnt):
                    on = ctrl_mask(i, int(ip[mi + 2 * k]), int(ip[mi + 2 * k + 1]))
                    ang = ang + on.to(torch.float32) * float(fp[mf + k])
                c, sn = torch.cos(ang).to(xr.dtype), torch.sin(ang).to(xr.dtype)
                x, y = cur[i]
                cur[i] = (x * c - y * sn, x * sn + y * c)
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

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "window_sweep.cu"
#: Build directory (listed in .gitignore), beside the package's checkout.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rustqip_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIB = None


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the window kernel builds with the CUDA toolkit")


def build() -> Path:
    """Compile csrc/window_sweep.cu into a shared library (once per source
    version) and return its path. Raises with nvcc's output on failure."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libwindow_sweep_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rq_window_sweep
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def window_sweep(
    n: int, xr, xi, seg_sizes, ksteps, prog: "WindowProgram | None" = None
):
    """Run one strip window over float32 (R, 128) planes, in place.

    A CUDA state launches the Hopper kernel (and counts the launch) or
    raises; a CPU state takes ``window_sweep_reference``. ``prog`` is the
    window's encoded step program (``encode_window``); pass it to skip
    re-encoding (compiled circuits do)."""
    _check_planes(n, xr, xi)
    if prog is None:
        prog = encode_window(n, seg_sizes, ksteps)
    if xr.device.type == "cpu":
        return window_sweep_reference(n, xr, xi, seg_sizes, ksteps, prog=prog)
    if xr.device.type != "cuda":
        raise ValueError(f"window_sweep: no kernel for device {xr.device}")
    if not prog.out_mask:
        return xr, xi
    if (1 << (prog.max_rbf_bit + 1)) > prog.bt:
        raise ValueError(
            f"rbf bit {prog.max_rbf_bit} does not fit a {prog.bt}-row tile "
            "(plan with HopperSmemAdmission)"
        )
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("window_sweep needs 16-byte aligned planes")
    iprog, fprog, mats = prog.tensors(xr.device)
    seg = list(prog.seg_sizes) + [1] * (5 - len(prog.seg_sizes))
    srows = xr.shape[0] >> prog.h
    with torch.cuda.device(xr.device):
        err = _lib().rq_window_sweep(
            xr.data_ptr(), xi.data_ptr(), iprog.data_ptr(), fprog.data_ptr(),
            mats.data_ptr(), prog.h, prog.nsteps, prog.bt, prog.in_mask,
            prog.out_mask, int(prog.scratch), *seg, srows // prog.bt,
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"window_sweep kernel launch failed: CUDA error {err}")
    LAUNCHES["window_sweep"] += 1
    for k in prog.kinds:
        KIND_LAUNCHES[k] += 1
    return xr, xi


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


def c64_low_matmul(xr, xi, B: np.ndarray):
    """(xr + i xi) @ B.T for a C x C complex block matrix B on (R, C)
    planes: a one-"low"-step window of the same kernel for CUDA float32
    (as ``pallas_kernels.c64_low_matmul`` takes its kernel on the TPU),
    plain matmuls otherwise. Like the JAX function it leaves its inputs
    alone (callers such as a wide controlled op read them again), so the
    in-place kernel runs on copies."""
    if xr.is_cuda and xr.dtype == torch.float32 and xr.shape[1] == _C:
        prog = _low_program(xr.shape[0], B)
        return window_sweep(prog.n, xr.clone(), xi.clone(), prog.seg_sizes,
                            [("low", B)], prog=prog)
    bt = np.ascontiguousarray(np.asarray(B).T)
    br = torch.as_tensor(np.real(bt), dtype=xr.dtype, device=xr.device)
    bi = torch.as_tensor(np.imag(bt), dtype=xr.dtype, device=xr.device)
    return xr @ br - xi @ bi, xr @ bi + xi @ br

