"""Kernel-window admission: which collected windows the window kernel
takes, with what tile, and which ops fusion leaves for it.

The JAX package decides this from TPU VMEM models spread over three places
(``pallas_kernels.window_block_rows``:881, ``window_vmem_request``:820,
``WINDOW_VMEM_CEIL``:814, read by ``real_apply._window_kernel_applicable``
:859, ``butterfly_eligible``:332 and ``window_joint_ok``:370). Here the
same decisions sit behind ONE object handed to ``plan_sweeps``,
``butterfly_eligible`` and ``window_joint_ok``, so fusion and planning can
never read different rules:

* ``TpuReferenceAdmission`` — an exact copy of the JAX package's rules
  with its default knobs. Plans made under it equal the reference's entry
  by entry (the plan-equality tests use it).
* ``HopperSmemAdmission`` — the H100 kernel's rules: a CTA holds ``bt``
  rows of every strip of the window (both planes) in shared memory, so the
  tile comes from the 227 KB per-block budget, and an in-tile row
  butterfly ("rbf") needs its partner row inside the tile. Used when the
  state lives on CUDA. Plans may then differ from the reference's;
  amplitudes may not.

Whether a run takes the kernels at all is ``kernel_policy``, written once
here: CUDA by default, float32 only.
"""

from __future__ import annotations

import torch

from rustqip_tpu_torch.types import geometry, row_segment_shape

#: Longest op run collected into one window (real_apply.py:261).
WINDOW_MAX_OPS = 64
#: Largest matmul-step count handed to the kernel (real_apply.py:265).
WINDOW_KERNEL_MAX_LOW = 24

_C = 128

#: Step kinds that combine strips at one (row, lane) position only. A
#: window of these alone takes the window kernel's register path
#: (``csrc/window_stream.cu``), which holds no tile; any other window takes
#: the tile path (``csrc/window_sweep.cu``).
STREAM_KINDS = frozenset({"mix", "diag", "cmix"})


#: Row-support groups a diag entry holds as lane-vector factors; above it
#: the entry holds angles and the kernel takes one sincos per element (the
#: JAX package's ``_diag_mask_max`` default, pallas_kernels.py:29).
DIAG_MASK_MAX = 4


def diag_angle_mode(hq, groups) -> bool:
    """Whether a collected ``diag`` step (its monomial groups) in a window
    on row qubits ``hq`` takes angle mode in some strip: more than
    ``DIAG_MASK_MAX`` distinct row supports among its mixed monomials once
    the window qubits are fixed. The strip with every window bit 1 keeps
    the most; ``window_kernel.encode_window`` counts them strip by strip."""
    win = set(hq)
    supports = {tuple(q for q in rq if q not in win) for rq, _cq, _c in groups[3]}
    supports.discard(())
    return len(supports) > DIAG_MASK_MAX


def takes_registers(kinds) -> bool:
    """Whether a window whose steps are of ``kinds`` takes the register
    path: the one rule ``encode_window`` (kernel steps) and
    ``HopperSmemAdmission`` (collected steps) read. The two step formats
    name the strip-local kinds alike, and a matrix step is ``low`` in one
    and ``low`` or ``lowr`` in the other, so both give one answer."""
    return set(kinds) <= STREAM_KINDS


def window_seg_sizes(n: int, hq):
    """Row-space segment sizes around the window bits:
    (s_0, ..., s_h) with rows = s_0 * 2 * s_1 * 2 * ... * s_h."""
    m, _, _ = geometry(n)
    return row_segment_shape(n, m, list(hq))[0::2]


def _step_counts(steps):
    """(n_low, n_diag, n_cbf(+cmix), rbf_bits, n_rmix, n_rmix_mats, n_mix)
    of a collected window (the counts _window_kernel_applicable reads)."""
    rbf_bits = [s[1] for s in steps if s[0] == "rbf"]
    n_rmix_mats = sum(
        sum(1 for b in s[2][1].values() if b[0] == "mat")
        for s in steps
        if s[0] == "rmix"
    )
    return (
        sum(1 for s in steps if s[0] == "low"),
        sum(1 for s in steps if s[0] == "diag"),
        sum(1 for s in steps if s[0] in ("cbf", "cmix")),
        rbf_bits,
        sum(1 for s in steps if s[0] == "rmix"),
        n_rmix_mats,
        sum(1 for s in steps if s[0] == "mix"),
    )


def _worth_it(h, n_low, n_diag, n_cbf, n_rbf, n_rmix, n_mix) -> bool:
    """The JAX package's "worth invoking" rule with its default knobs
    (``RUSTQIP_TPU_KERNEL_PURE_MIX`` on): pure-mix and lone-butterfly
    windows ride the kernel too."""
    return (
        n_diag >= 1
        or n_low + n_cbf + n_rbf + n_rmix >= 2
        or n_cbf + n_rbf >= 1
        or (h >= 1 and n_low + n_rmix >= 1)
        or (h >= 1 and n_mix >= 1)
    )


class TpuReferenceAdmission:
    """The JAX package's TPU admission, copied exactly (default knobs)."""

    name = "tpu_reference"
    #: Largest row bit collected as an in-block row butterfly
    #: (real_apply.WINDOW_RBF_MAX_BIT).
    rbf_max_bit = 8
    #: Below this many state rows no kernel window forms.
    min_state_rows = 64
    #: Largest block: bounds rbf partners for fusion's keep predicate.
    max_block_rows = 512
    #: Lowest row bit a fused joint may touch (64-row blocks need the
    #: trailing segment to hold 2^6 rows).
    min_joint_row_bit = 6
    #: A diagonal with a log-magnitude group never becomes a window's
    #: ``diag`` step (``real_apply._window_diag_plan``:395).
    diag_mag_max = None

    BLOCK_ROWS = 512
    WINDOW_VMEM_CEIL = 100 * 1024 * 1024
    _VMEM_DEFAULT = 16 * 1024 * 1024

    @staticmethod
    def _n_matmul_steps(steps) -> int:
        n = 0
        for s in steps:
            if s[0] == "low":
                n += 1
            elif s[0] == "rmix":
                n += sum(1 for b in s[1].values() if b[0] != "scalar")
        return n

    def window_vmem_request(self, h: int, steps, br: int, n_mats=None) -> int:
        """``pallas_kernels.window_vmem_request``:820 (TPU VMEM model)."""
        ns = 1 << h
        blk = br * _C * 4
        buffers = 8 * ns * blk
        has_diag = any(s[0] == "diag" for s in steps)
        diag_mult = (3 if br >= 256 else 2) if has_diag else 1
        strip_mult = ns if ns >= 16 else max(1, ns // 2)
        stack = len(steps) * blk * diag_mult * strip_mult
        stack += sum(2 * ns * blk for s in steps if s[0] == "rmix")
        if n_mats is None:
            n_mats = 3 * self._n_matmul_steps(steps)
        mats = n_mats * _C * _C * 4
        total = buffers + stack + mats
        headroom = total // 2 if ns >= 16 else total // 8
        return max(self._VMEM_DEFAULT, total + headroom)

    def window_block_rows(self, h: int, steps) -> int:
        """``pallas_kernels.window_block_rows``:881 with default knobs."""
        if not any(s[0] in ("diag", "rmix") for s in steps):
            return self.BLOCK_ROWS if h <= 2 else self.BLOCK_ROWS // 2
        if not any(s[0] == "rmix" for s in steps):
            if self.window_vmem_request(h, steps, 512) <= self.WINDOW_VMEM_CEIL:
                return 512
        if h <= 1:
            return self.BLOCK_ROWS
        return 128 if h == 2 else 64

    def block_rows(self, h: int, steps, seg_last: int) -> int:
        return min(self.window_block_rows(h, steps), seg_last)

    def applicable(self, n: int, hq, steps) -> bool:
        """``real_apply._window_kernel_applicable``:859."""
        h = len(hq)
        _, _, C = geometry(n)
        if h > 4 or C != 128:
            return False
        segs = window_seg_sizes(n, hq)
        br = self.block_rows(h, steps, segs[-1])
        if br < 64:
            return False
        n_low, n_diag, n_cbf, rbf_bits, n_rmix, n_rmix_mats, n_mix = (
            _step_counts(steps)
        )
        if rbf_bits and (1 << (max(rbf_bits) + 1)) > br:
            return False
        if n_low + n_rmix_mats > WINDOW_KERNEL_MAX_LOW:
            return False
        if (
            self.window_vmem_request(
                h, steps, br, n_mats=3 * (n_low + n_rmix_mats)
            )
            > self.WINDOW_VMEM_CEIL
        ):
            return False
        return _worth_it(h, n_low, n_diag, n_cbf, len(rbf_bits), n_rmix, n_mix)


#: Dynamic shared memory one H100 block may use (bytes), less the small
#: per-CTA header the kernel keeps in front of the tile.
HOPPER_SMEM_BYTES = 232448
HOPPER_SMEM_HEADER = 256


def hopper_tile_rows(h: int, has_rmix: bool, seg_last: int) -> int:
    """Rows per strip a window-kernel CTA holds: the largest power of two
    whose tile (2^h strips x rows x 128 lanes x 2 planes x 4 B, doubled
    for an rmix step's output scratch) fits the shared-memory budget,
    capped by the trailing segment so the tile stays one contiguous run
    of rows in every strip."""
    per_row = (1 << h) * _C * 2 * 4 * (2 if has_rmix else 1)
    rows = 1
    while 2 * rows * per_row <= HOPPER_SMEM_BYTES - HOPPER_SMEM_HEADER:
        rows *= 2
    return min(rows, seg_last)


class HopperSmemAdmission:
    """The H100 window kernel's admission (shared-memory tiles). The tile's
    8-row minimum binds only windows that take the tile path: a window of
    strip-local steps takes the register path, whose warps each take one
    strip-local row wherever the window bits fall, and is admitted whatever
    its trailing row segment.

    A ``diag`` step in angle mode (``diag_angle_mode``) takes only a window
    of h = 0. Each strip of a wider window keeps its own entry of lane
    angles, one part per group, and the kernel reads a part for every
    group whose row mask holds at every element: on an H100 80GB HBM3 at
    n = 28, QPE-28's phase product (17 groups a strip) took 4.8 ms as a
    step of an h = 4 tile window and 4.2 ms of an h = 4 register window,
    and 1.7 ms as a window of its own."""

    name = "hopper_smem"
    #: A 1-strip tile holds 128 rows, so row butterflies reach bit 6.
    rbf_max_bit = 6
    min_state_rows = 8
    max_block_rows = 128
    min_joint_row_bit = 3
    #: Smallest tile worth a launch: 8 rows per strip.
    MIN_TILE_ROWS = 8
    #: Largest sum of the absolute coefficients of a diagonal's
    #: log-magnitude group that a window's ``diag`` step leaves out (it
    #: carries the angle group alone). At each index the log-magnitude x
    #: is a sum of some of those coefficients, so |x| <= 2^-26. exp(x)
    #: rounds to exactly 1.0f for |x| < 2^-25, the half-ulp of float32
    #: below 1.0 (above it the half-ulp is 2^-24), and the factor 2 between
    #: the two covers the float32 evaluation of the sum. The window kernel
    #: takes float32 planes alone (``window_kernel.window_sweep``), so the
    #: step computes what the plain float32 pass, whose magnitude factor
    #: is then 1.0f, computes.
    diag_mag_max = 2.0 ** -26

    def block_rows(self, h: int, steps, seg_last: int) -> int:
        return hopper_tile_rows(
            h, any(s[0] == "rmix" for s in steps), seg_last
        )

    def applicable(self, n: int, hq, steps) -> bool:
        h = len(hq)
        _, _, C = geometry(n)
        if h > 4 or C != 128:
            return False
        segs = window_seg_sizes(n, hq)
        bt = self.block_rows(h, steps, segs[-1])
        if bt < self.MIN_TILE_ROWS and not takes_registers(s[0] for s in steps):
            return False
        n_low, n_diag, n_cbf, rbf_bits, n_rmix, n_rmix_mats, n_mix = (
            _step_counts(steps)
        )
        if rbf_bits and (1 << (max(rbf_bits) + 1)) > bt:
            return False
        if n_low + n_rmix_mats > WINDOW_KERNEL_MAX_LOW:
            return False
        if h and any(s[0] == "diag" and diag_angle_mode(hq, s[1]) for s in steps):
            return False
        return _worth_it(h, n_low, n_diag, n_cbf, len(rbf_bits), n_rmix, n_mix)


def thin_segment(seg_sizes) -> bool:
    """Whether a window's trailing row segment is under the tile path's
    smallest tile (``HopperSmemAdmission.MIN_TILE_ROWS``): on such a
    segment the H100's admission takes only windows that
    ``takes_registers``."""
    return seg_sizes[-1] < HopperSmemAdmission.MIN_TILE_ROWS


TPU_REFERENCE = TpuReferenceAdmission()
HOPPER = HopperSmemAdmission()


def for_device(device) -> "TpuReferenceAdmission | HopperSmemAdmission":
    """Hopper admission for CUDA states, the reference's elsewhere."""
    return HOPPER if torch.device(device).type == "cuda" else TPU_REFERENCE


def kernel_policy(devices, dtype: torch.dtype, kernel_ok: "bool | None" = None) -> bool:
    """Whether a run takes the kernels: ``kernel_ok`` when the caller says,
    else whether every one of ``devices`` is CUDA; never unless the planes'
    real ``dtype`` is float32 (the kernels are float32-only, as in the JAX
    package). The one rule that single-device circuits, per-call op runs
    and sharded schedules read, and that ``real_apply.apply_op_ri`` reads
    for each monomial pass (``engine/monomial.py``) on its planes' device
    and dtype: the pass's kernel on CUDA float32 planes, its plain version
    on the CPU, for float64, and where the caller turns the permutation
    kernels off (``swap_kernel=False``, passed here as ``kernel_ok``)."""
    if kernel_ok is None:
        kernel_ok = all(torch.device(d).type == "cuda" for d in devices)
    return bool(kernel_ok) and dtype == torch.float32
