"""OpenQASM 2.0 text export.

Port of ``rustqip_tpu/qasm/export.py``: the same text, character for
character, for a circuit built the same way in either package (its comment
lines included).

Re-design of ``qip/src/qasm.rs``: walk the builder's recorded pipeline and
emit qelib1 gates. Same conventions as the reference:

* one classical bit per distinct collapsed-measured qubit, allocated in
  sorted qubit order (qasm.rs:35-52);
* CNOT entries emit ``cx`` control->target (:127-134); SWAP emits pairwise
  ``swap`` across register halves (:137-154);
* Rz angles print as decimal radians (trimmed) or symbolic ``k*pi/m``
  (:192-214).

Beyond the reference: arbitrary (and natively-conditioned) unitaries export
as REAL gate streams via export-time decomposition (``decompose.py`` —
ZYZ / quantum Shannon / cu3+ccx special cases), where the reference could
only export what its build-time decompositions produced (conditioning a
raw MAT is ``todo!()`` at builder.rs:808). Controlled ops with many
controls take a clean-ancilla Toffoli-ladder path (an ``anc`` qreg is
emitted on demand), so control count no longer hits the synthesis cap.
Only stochastic measurements and uncontrolled/target unitaries wider than
``decompose.qsd_cap()`` fall back to comments (OpenQASM 2.0 has no construct
for either).
"""

from __future__ import annotations

from typing import List

import numpy as np

from rustqip_tpu_torch.builder.circuit_objects import (
    ControlledMatGate,
    FnGate,
    GlobalPhaseGate,
    MatGate,
    MeasurementObject,
    NamedGate,
    ReflectionGate,
    RzGate,
    SparseMatGate,
)
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.qasm.decompose import (
    qsd_cap,
    synthesize_controlled,
    synthesize_mcu,
    synthesize_unitary,
    zyz_angles,
)
from rustqip_tpu_torch.types import Angle, PiRational


def format_angle(theta: Angle) -> str:
    """Decimal radians (trimmed) or exact ``k*pi/m`` (ref qasm.rs:192-214)."""
    if isinstance(theta, PiRational):
        num, den = theta.numerator, theta.denominator
        if den == 1:
            return f"{num}*pi"
        return f"{num}*pi/{den}"
    text = f"{float(theta):.12f}".rstrip("0").rstrip(".")
    return text if text else "0"


def _fmt(x: float) -> str:
    return format_angle(float(x))


def _emit_ir(gates, out: List[str], n_main: int = 1 << 62) -> None:
    """Print decompose.py gate IR as qelib1 statements. Indices at or above
    ``n_main`` refer to the export-time ancilla register ``anc``."""

    def q(i: int) -> str:
        return f"q[{i}]" if i < n_main else f"anc[{i - n_main}]"

    for name, params, qs in gates:
        if name == "cx":
            out.append(f"cx {q(qs[0])},{q(qs[1])};")
        elif name == "ccx":
            out.append(f"ccx {q(qs[0])},{q(qs[1])},{q(qs[2])};")
        elif name == "u1":
            out.append(f"u1({_fmt(params[0])}) {q(qs[0])};")
        elif name == "u3":
            t, p, l = params
            out.append(f"u3({_fmt(t)},{_fmt(p)},{_fmt(l)}) {q(qs[0])};")
        else:  # pragma: no cover
            raise AssertionError(name)


_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
_SWAP4 = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)


def _reflection_mcz(k: int) -> ControlledMatGate:
    """The multi-controlled Z at the core of a k-qubit reflection's gate
    expansion (H^k X^k mcZ X^k H^k = -D; the -1 is QASM-2.0-inexpressible
    global phase, commented like every ``GlobalPhaseGate``)."""
    return ControlledMatGate(k - 1, MatGate(_Z))


def _emit_reflection(obj: ReflectionGate, indices, out: List[str],
                     n_main: int) -> None:
    k = obj.n
    if k == 1:
        # 2|+><+| - I == X exactly.
        out.append(f"x q[{indices[0]}];")
        return
    out.append(
        f"// reflection 2|s><s|-I on {list(indices)} as H X mcZ X H "
        "(global phase -1 ignored in OpenQASM 2.0)"
    )
    for q in indices:
        out.append(f"h q[{q}];")
    for q in indices:
        out.append(f"x q[{q}];")
    _emit_controlled_mat(_reflection_mcz(k), indices, out, n_main)
    for q in indices:
        out.append(f"x q[{q}];")
    for q in indices:
        out.append(f"h q[{q}];")


def _ctrl_target_width(obj: ControlledMatGate) -> int:
    return obj.mat.n


def _ladder_ancillas_needed(obj: ControlledMatGate) -> int:
    """Ancillas the MCU Toffoli-ladder path needs for this op (0 = the
    dense-embed/special-case paths handle it)."""
    nc, k = obj.n_ctrl, _ctrl_target_width(obj)
    if nc >= 2 and (nc + k > qsd_cap() or nc >= 4) and k + 1 <= qsd_cap():
        return nc - 1
    return 0


def _emit_controlled_mat(
    obj: ControlledMatGate, indices, out: List[str], n_main: int
):
    nc = obj.n_ctrl
    ctrls = list(indices[:nc])
    tgts = list(indices[nc:])
    mat = obj.mat
    k = len(tgts)
    ladder = _ladder_ancillas_needed(obj)
    if isinstance(mat, ReflectionGate):
        # C(D) synthesizes from the dense 2/N J - I (the RELATIVE phase
        # of a controlled reflection is observable, so no phase-dropping
        # gate expansion here — contrast _emit_reflection).
        from rustqip_tpu_torch.ops.matrix_ops import ReflectionOp, op_to_dense

        if mat.n + nc > qsd_cap() and not ladder:
            out.append(
                f"// controlled reflection on {list(indices)} exceeds "
                f"synthesis cap ({qsd_cap()} qubits)"
            )
            return
        data = op_to_dense(ReflectionOp(tuple(range(mat.n))))
    elif isinstance(mat, SparseMatGate):
        from rustqip_tpu_torch.ops.matrix_ops import SparseOp, op_to_dense

        if mat.n + nc > qsd_cap() and not ladder:
            out.append(
                f"// controlled sparse unitary on {list(indices)} exceeds "
                f"synthesis cap ({qsd_cap()} qubits)"
            )
            return
        data = op_to_dense(SparseOp(tuple(range(mat.n)), mat.rows))
    elif isinstance(mat, FnGate):
        from rustqip_tpu_torch.ops.matrix_ops import FnOp, op_to_dense

        if mat.n + nc > qsd_cap() and not ladder:
            out.append(
                f"// controlled traced-function unitary {mat.tag!r} on "
                f"{list(indices)} exceeds synthesis cap ({qsd_cap()} qubits)"
            )
            return
        data = op_to_dense(
            FnOp(tuple(range(mat.n)), mat.fn, mat.tag, mat.conjugated,
                 mat.self_transpose, mat.diagonal)
        )
    else:
        data = mat.data
    if k == 1:
        if np.allclose(data, _X, atol=1e-12):
            if nc == 1:
                out.append(f"cx q[{ctrls[0]}],q[{tgts[0]}];")
                return
            if nc == 2:
                out.append(f"ccx q[{ctrls[0]}],q[{ctrls[1]}],q[{tgts[0]}];")
                return
        if nc == 1:
            alpha, theta, phi, lam = zyz_angles(data)
            if abs(alpha) > 1e-12:
                out.append(f"u1({_fmt(alpha)}) q[{ctrls[0]}];")
            out.append(
                f"cu3({_fmt(theta)},{_fmt(phi)},{_fmt(lam)}) "
                f"q[{ctrls[0]}],q[{tgts[0]}];"
            )
            return
    if k == 2 and nc == 1 and np.allclose(data, _SWAP4, atol=1e-12):
        out.append(f"cswap q[{ctrls[0]}],q[{tgts[0]}],q[{tgts[1]}];")
        return
    if ladder:
        anc = [n_main + i for i in range(ladder)]
        _emit_ir(synthesize_mcu(data, ctrls, tgts, anc), out, n_main)
        return
    if nc + k > qsd_cap():
        out.append(
            f"// controlled unitary on {list(indices)} exceeds synthesis "
            f"cap ({qsd_cap()} qubits)"
        )
        return
    _emit_ir(
        synthesize_controlled(data, ctrls, tgts, exact_phase=False), out
    )


def _emit_unitary(obj, indices, out: List[str]) -> None:
    if isinstance(obj, NamedGate):
        name = obj.name
        if name in ("X", "Y", "Z", "H", "S", "T"):
            for q in indices:
                out.append(f"{name.lower()} q[{q}];")
        elif name == "CNOT":
            if indices:
                c = indices[0]
                for t in indices[1:]:
                    out.append(f"cx q[{c}],q[{t}];")
        elif name == "SWAP":
            k = len(indices)
            if k < 2:
                return
            if k % 2 == 0:
                half = k // 2
                for i in range(half):
                    out.append(
                        f"swap q[{indices[i]}],q[{indices[i + half]}];"
                    )
            else:
                out.append(
                    f"// swap with odd arity {list(indices)} not directly "
                    "supported"
                )
    elif isinstance(obj, RzGate):
        ang = format_angle(obj.theta)
        for q in indices:
            out.append(f"rz({ang}) q[{q}];")
    elif isinstance(obj, GlobalPhaseGate):
        out.append(
            f"// global phase {format_angle(obj.theta)} "
            "(ignored in OpenQASM 2.0)"
        )
    elif isinstance(obj, MatGate):
        if obj.n == 1:
            _, theta, phi, lam = zyz_angles(obj.data)
            out.append(
                f"u3({_fmt(theta)},{_fmt(phi)},{_fmt(lam)}) q[{indices[0]}];"
            )
        elif obj.n <= qsd_cap():
            _emit_ir(
                synthesize_unitary(obj.data, list(indices),
                                   exact_phase=False),
                out,
            )
        else:
            out.append(
                f"// unitary on {list(indices)} exceeds synthesis cap "
                f"({qsd_cap()} qubits)"
            )
    elif isinstance(obj, SparseMatGate):
        if obj.n <= qsd_cap():
            from rustqip_tpu_torch.ops.matrix_ops import SparseOp, op_to_dense

            data = op_to_dense(SparseOp(tuple(range(obj.n)), obj.rows))
            _emit_ir(
                synthesize_unitary(data, list(indices), exact_phase=False),
                out,
            )
        else:
            out.append(
                f"// sparse unitary on {list(indices)} exceeds synthesis "
                f"cap ({qsd_cap()} qubits)"
            )
    elif isinstance(obj, FnGate):
        # OpenQASM needs explicit gates: materialize the traced fn over
        # its 2^n rows (fine at synthesis widths) and synthesize like any
        # dense unitary; wide oracles have no QASM 2.0 form.
        if obj.n <= qsd_cap():
            from rustqip_tpu_torch.ops.matrix_ops import FnOp, op_to_dense

            data = op_to_dense(
                FnOp(tuple(range(obj.n)), obj.fn, obj.tag,
                     obj.conjugated, obj.self_transpose, obj.diagonal)
            )
            _emit_ir(
                synthesize_unitary(data, list(indices), exact_phase=False),
                out,
            )
        else:
            out.append(
                f"// traced-function unitary {obj.tag!r} on "
                f"{list(indices)} exceeds synthesis cap ({qsd_cap()} qubits)"
            )
    elif isinstance(obj, ControlledMatGate):  # pragma: no cover
        # to_openqasm intercepts ControlledMatGate with the real n_main
        # (ancilla indices start after the main register); reaching here
        # without it would mis-address every qubit as anc[...].
        raise CircuitError(
            "ControlledMatGate must go through _emit_controlled_mat with "
            "n_main set"
        )


def to_openqasm(builder) -> str:
    """Export a builder's circuit as OpenQASM 2.0 text (repeat blocks are
    unrolled — OpenQASM 2.0 has no loops)."""
    from rustqip_tpu_torch.builder.circuit_objects import flatten_pipeline

    pipeline = flatten_pipeline(builder.make_subcircuit())
    n_qubits = builder.n

    measured = sorted(
        {
            q
            for indices, co in pipeline
            if isinstance(co.obj, MeasurementObject) and not co.obj.stochastic
            for q in indices
        }
    )
    classical_map = {q: c for c, q in enumerate(measured)}

    n_anc = max(
        (
            _ladder_ancillas_needed(co.obj)
            if isinstance(co.obj, ControlledMatGate)
            else _ladder_ancillas_needed(_reflection_mcz(co.obj.n))
            for _, co in pipeline
            if isinstance(co.obj, ControlledMatGate)
            or (isinstance(co.obj, ReflectionGate) and co.obj.n >= 2)
        ),
        default=0,
    )

    out: List[str] = ["OPENQASM 2.0;", 'include "qelib1.inc";']
    out.append(f"qreg q[{n_qubits}];")
    if n_anc:
        out.append(f"qreg anc[{n_anc}];")
    if measured:
        out.append(f"creg c[{len(measured)}];")

    for indices, co in pipeline:
        obj = co.obj
        if isinstance(obj, MeasurementObject):
            if obj.stochastic:
                out.append(
                    f"// stochastic measurement over {list(indices)} "
                    "(not in OpenQASM 2.0)"
                )
            else:
                for q in indices:
                    if q in classical_map:
                        out.append(f"measure q[{q}] -> c[{classical_map[q]}];")
        elif isinstance(obj, ControlledMatGate):
            _emit_controlled_mat(obj, indices, out, n_qubits)
        elif isinstance(obj, ReflectionGate):
            _emit_reflection(obj, indices, out, n_qubits)
        else:
            _emit_unitary(obj, indices, out)

    return "\n".join(out) + "\n"


def write_openqasm_file(builder, path) -> None:
    """Write the circuit as OpenQASM 2.0 into ``path`` (ref qasm.rs:103)."""
    with open(path, "w") as f:
        f.write(to_openqasm(builder))
