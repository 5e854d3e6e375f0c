"""OpenQASM 2.0 import: parse qelib1-subset text into a LocalBuilder.

Port of ``rustqip_tpu/qasm/importer.py``. The builder is a ``LocalBuilder()``
on the card unless the caller passes one. One deliberate difference: a
top-level ``swap`` statement records the builder's SWAP (a ``SwapOp``, which
the compiler defers into its qubit relabeling and the row-swap pass runs),
where the JAX package applies a dense 4 x 4 matrix; the state is the same.

No reference analog (RustQIP only exports); added here so exported gate
streams round-trip — the acceptance check for export-time decomposition of
natively-conditioned circuits. Supports the gate set the exporter emits
plus the common qelib1 one- and two-qubit names, custom ``gate``
definitions (expanded recursively at import time), ``reset`` (swap with a
zeroed ancilla), and classically-conditioned ``if (creg==val)`` statements
via the deferred-measurement principle: the condition is lowered to a
quantum control on the measured source qubits, which is exact as long as
those qubits are untouched since their measurement (enforced).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rustqip_tpu_torch.errors import CircuitError

_TOKEN_RE = re.compile(r"^(?P<name>[a-zA-Z_][\w]*)\s*(\((?P<params>[^)]*)\))?\s*(?P<args>.*)$")
_QARG_RE = re.compile(r"^(?P<reg>[a-zA-Z_][\w]*)\s*(\[\s*(?P<idx>\d+)\s*\])?$")
_GATE_DEF_RE = re.compile(
    r"gate\s+(?P<name>[a-zA-Z_]\w*)\s*(?:\(\s*(?P<params>[^)]*)\))?"
    r"\s*(?P<qargs>[a-zA-Z_]\w*(?:\s*,\s*[a-zA-Z_]\w*)*)\s*\{(?P<body>[^{}]*)\}"
)
_IF_RE = re.compile(
    r"^if\s*\(\s*(?P<creg>[a-zA-Z_]\w*)\s*==\s*(?P<val>\d+)\s*\)\s*(?P<stmt>.+)$"
)
_IDENT_RE = re.compile(r"[a-zA-Z_]\w*")
#: numeric literal incl. scientific notation (1e-07, 2.5e3, .5) — stripped
#: before the identifier scan so the exponent's "e" is not read as a name
_NUMBER_RE = re.compile(r"(?<![\w.])(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")

_SAFE_NAMES = {"pi": np.pi}


def _eval_param(expr: str, env: Optional[Dict[str, float]] = None) -> float:
    """Evaluate a QASM angle expression: arithmetic over numbers (incl.
    scientific notation — Qiskit prints tiny angles like
    6.123233995736766e-17), ``pi``, and (inside a gate body) the gate's
    formal parameter names."""
    names = dict(_SAFE_NAMES)
    if env:
        names.update(env)
    if not re.fullmatch(r"[\w\s\.\+\-\*/\(\)]*", expr):
        raise CircuitError(f"Unsupported QASM parameter expression {expr!r}")
    for ident in _IDENT_RE.findall(_NUMBER_RE.sub(" ", expr)):
        if ident not in names:
            raise CircuitError(f"Unknown name {ident!r} in parameter {expr!r}")
    try:
        return float(eval(expr, {"__builtins__": {}}, names))  # noqa: S307
    except Exception as e:
        raise CircuitError(f"Bad QASM parameter {expr!r}: {e}") from e


# Matrix semantics shared with the exporter's synthesis backend: a
# convention change there must flow here or round-trips silently break.
from rustqip_tpu_torch.qasm.decompose import _u3_matrix as _u3  # noqa: E402


def _u1(lam: float) -> np.ndarray:
    from rustqip_tpu_torch.qasm.decompose import gate_matrix

    return gate_matrix("u1", (lam,))


def _rot(axis: str, theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    if axis == "x":
        return np.array([[c, -1j * s], [-1j * s, c]])
    if axis == "y":
        return np.array([[c, -s], [s, c]])
    return np.diag([np.exp(-1j * theta / 2), np.exp(1j * theta / 2)])


def _ctrl(mat: np.ndarray) -> np.ndarray:
    dim = mat.shape[0]
    out = np.eye(2 * dim, dtype=np.complex128)
    out[dim:, dim:] = mat
    return out


_SWAP4 = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)

#: name -> (n_params, matrix factory over qubits in listed order)
_GATES = {
    "id": (0, lambda: np.eye(2)),
    "x": (0, lambda: _X),
    "y": (0, lambda: np.array([[0, -1j], [1j, 0]])),
    "z": (0, lambda: np.diag([1.0, -1.0])),
    "h": (0, lambda: np.array([[1, 1], [1, -1]]) / np.sqrt(2)),
    "s": (0, lambda: np.diag([1.0, 1j])),
    "sdg": (0, lambda: np.diag([1.0, -1j])),
    "t": (0, lambda: np.diag([1.0, np.exp(1j * np.pi / 4)])),
    "tdg": (0, lambda: np.diag([1.0, np.exp(-1j * np.pi / 4)])),
    "sx": (0, lambda: 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]])),
    "u1": (1, _u1),
    "u2": (2, lambda p, l: _u3(np.pi / 2, p, l)),
    "u3": (3, _u3),
    "u": (3, _u3),
    "p": (1, _u1),
    "rx": (1, lambda t: _rot("x", t)),
    "ry": (1, lambda t: _rot("y", t)),
    # qelib1 defines rz(phi) as u1(phi)
    "rz": (1, _u1),
    "cx": (0, lambda: _ctrl(_X)),
    "cy": (0, lambda: _ctrl(np.array([[0, -1j], [1j, 0]]))),
    "cz": (0, lambda: _ctrl(np.diag([1.0, -1.0]))),
    "ch": (0, lambda: _ctrl(np.array([[1, 1], [1, -1]]) / np.sqrt(2))),
    "cu1": (1, lambda l: _ctrl(_u1(l))),
    "cp": (1, lambda l: _ctrl(_u1(l))),
    "cu3": (3, lambda t, p, l: _ctrl(_u3(t, p, l))),
    # qelib1's crz expands to a TRUE controlled-Rz (relative phases only)
    "crz": (1, lambda l: _ctrl(_rot("z", l))),
    "swap": (0, lambda: _SWAP4),
    "ccx": (0, lambda: _ctrl(_ctrl(_X))),
    "cswap": (0, lambda: _ctrl(_SWAP4)),
}


@dataclass
class _GateDef:
    """A parsed custom ``gate`` definition (expanded at call sites)."""

    params: List[str]
    qargs: List[str]
    body: List[str]


@dataclass
class QasmCircuit:
    """Result of a QASM import: a ready builder plus handle bookkeeping."""

    builder: object
    n: int
    qubits: List[object]  # current single-qubit Registers, index order
    measurements: List[Tuple[int, object]] = field(default_factory=list)
    #: classical bit index -> ordinal of the producing measurement
    creg_map: Dict[int, int] = field(default_factory=dict)

    def finish(self):
        """Merge the remaining qubit registers into one (consumes them)."""
        return self.builder.merge_registers(
            [q for q in self.qubits if q is not None]
        )


def circuit_from_qasm(text: str, builder=None) -> QasmCircuit:
    """Parse OpenQASM 2.0 (qelib1 subset) into a LocalBuilder circuit.

    Multiple qregs concatenate in declaration order. ``measure`` becomes a
    collapsing measurement on the named qubit(s); ``barrier`` and comments
    are ignored. Custom ``gate`` definitions expand recursively at import
    time; ``reset`` swaps the qubit with a zeroed ancilla (the ancilla is
    retired, never returned to the temp pool); ``if (c==v) <gate>`` lowers
    to a quantum control on the measured source qubits (exact by the
    deferred-measurement principle; rejected if any source qubit was gated
    or reset after its measurement).
    """
    from rustqip_tpu_torch.builder.builder import LocalBuilder
    from rustqip_tpu_torch.dsl.program import negate_bitmask

    if builder is None:
        builder = LocalBuilder()
    # strip comments, then extract gate definitions ({} blocks would break
    # the flat ';' split below)
    body = re.sub(r"//[^\n]*", "", text)
    gate_defs: Dict[str, _GateDef] = {}

    def _grab_def(m: "re.Match") -> str:
        params = [p.strip() for p in (m.group("params") or "").split(",") if p.strip()]
        qargs = [q.strip() for q in m.group("qargs").split(",") if q.strip()]
        sts = [s.strip() for s in m.group("body").replace("\n", " ").split(";") if s.strip()]
        if not qargs:
            raise CircuitError(f"gate {m.group('name')} declares no qubits")
        gate_defs[m.group("name")] = _GateDef(params, qargs, sts)
        return " "

    body = _GATE_DEF_RE.sub(_grab_def, body)
    statements = [s.strip() for s in body.replace("\n", " ").split(";")]
    qreg_offsets: Dict[str, Tuple[int, int]] = {}
    cregs: Dict[str, Tuple[int, int]] = {}
    qubits: List[Optional[object]] = []
    out = QasmCircuit(builder=builder, n=0, qubits=qubits)
    n_c = 0
    #: qubit indices whose value is classical & equal to their last
    #: measurement outcome (untouched since) — the `if` lowering precondition
    fresh: set = set()

    def qubit_indices(args: str) -> List[int]:
        idxs = []
        for arg in args.split(","):
            m = _QARG_RE.match(arg.strip())
            if not m or m.group("reg") not in qreg_offsets:
                raise CircuitError(f"Bad qubit argument {arg!r}")
            off, size = qreg_offsets[m.group("reg")]
            if m.group("idx") is None:
                idxs.extend(range(off, off + size))
            else:
                i = int(m.group("idx"))
                if i >= size:
                    raise CircuitError(f"Qubit index out of range: {arg!r}")
                idxs.append(off + i)
        return idxs

    def take_slots(idxs: Sequence[int]) -> List[object]:
        regs = []
        for qi in idxs:
            if qubits[qi] is None:
                raise CircuitError("Qubit reused before release")
            regs.append(qubits[qi])
            qubits[qi] = None
            fresh.discard(qi)
        return regs

    def apply_gate_call(
        b,
        name: str,
        params: List[float],
        idxs: List[int],
        _stack: frozenset = frozenset(),
    ) -> None:
        """Apply gate ``name`` on global qubit indices ``idxs`` through
        builder ``b`` (the plain builder or a ``Conditioned`` wrapper).
        ``_stack`` tracks in-flight custom-gate expansions: a self- or
        mutually-recursive definition has no finite expansion, so
        re-entry is a CircuitError rather than a RecursionError."""
        if name in gate_defs:
            if name in _stack:
                raise CircuitError(
                    f"Recursive gate definition: {name!r} expands to "
                    f"itself (via {sorted(_stack)})"
                )
            gd = gate_defs[name]
            if len(params) != len(gd.params):
                raise CircuitError(
                    f"{name} expects {len(gd.params)} parameters, got {len(params)}"
                )
            if len(idxs) != len(gd.qargs):
                raise CircuitError(
                    f"{name} expects {len(gd.qargs)} qubits, got {len(idxs)}"
                )
            if len(set(idxs)) != len(idxs):
                raise CircuitError(f"{name} applied to duplicate qubits")
            env = dict(zip(gd.params, params))
            qmap = dict(zip(gd.qargs, idxs))
            for st in gd.body:
                if st.startswith("barrier"):
                    continue
                tok = _TOKEN_RE.match(st)
                if not tok:
                    raise CircuitError(f"Bad statement in gate {name}: {st!r}")
                sub_params = []
                if tok.group("params"):
                    sub_params = [
                        _eval_param(p, env) for p in tok.group("params").split(",")
                    ]
                sub_idxs = []
                for arg in tok.group("args").split(","):
                    arg = arg.strip()
                    if arg not in qmap:
                        raise CircuitError(
                            f"Unknown qubit {arg!r} in gate {name} body"
                        )
                    sub_idxs.append(qmap[arg])
                apply_gate_call(
                    b,
                    tok.group("name"),
                    sub_params,
                    sub_idxs,
                    _stack | {name},
                )
            return
        if name not in _GATES:
            raise CircuitError(f"Unknown gate {name!r}")
        n_params, factory = _GATES[name]
        if len(params) != n_params:
            raise CircuitError(
                f"{name} expects {n_params} parameters, got {len(params)}"
            )
        if name == "swap" and b is builder and len(idxs) == 2:
            # the builder's SWAP: a SwapOp that the compiler defers into its
            # relabeling (the JAX package applies the dense 4 x 4 matrix)
            qa, qb = b.swap_registers(*take_slots(idxs))
            qubits[idxs[0]], qubits[idxs[1]] = qa, qb
            return
        mat = np.asarray(factory(*params), dtype=np.complex128)
        k = int(mat.shape[0]).bit_length() - 1
        if len(idxs) != k:
            raise CircuitError(f"{name} expects {k} qubits, got {len(idxs)}")
        regs = take_slots(idxs)
        merged = b.merge_registers(regs)
        merged = b.apply_matrix(merged, mat)
        for qi, q in zip(idxs, b.split_all_register(merged)):
            qubits[qi] = q

    def apply_statement(b, st: str) -> None:
        tok = _TOKEN_RE.match(st)
        if not tok or (tok.group("name") not in _GATES and tok.group("name") not in gate_defs):
            raise CircuitError(f"Unsupported QASM statement: {st!r}")
        params = []
        if tok.group("params"):
            params = [_eval_param(p) for p in tok.group("params").split(",")]
        apply_gate_call(b, tok.group("name"), params, qubit_indices(tok.group("args")))

    for st in statements:
        if not st:
            continue
        if st.startswith("OPENQASM") or st.startswith("include"):
            continue
        if st.startswith("barrier"):
            continue
        if st.startswith("opaque"):
            raise CircuitError(f"Unsupported QASM statement: {st!r}")
        m = _IF_RE.match(st)
        if m:
            creg = m.group("creg")
            if creg not in cregs:
                raise CircuitError(f"Unknown creg in condition: {st!r}")
            off, size = cregs[creg]
            val = int(m.group("val"))
            if val >= (1 << size):
                raise CircuitError(
                    f"Condition value {val} out of range for {creg}[{size}]"
                )
            inner = m.group("stmt").strip()
            if inner.startswith("measure") or inner.startswith("reset"):
                raise CircuitError(
                    f"Conditioned {inner.split()[0]} is not supported: {st!r}"
                )
            # Map each classical bit to its source qubit (bit j of val
            # compares against creg bit j, QASM little-endian). Two creg
            # bits measured from the SAME source qubit collapse to one
            # control: their classical values are necessarily equal, so
            # the condition either dedups (bits of val agree) or is
            # unsatisfiable (bits conflict) — collecting the handle twice
            # would otherwise fail deep in merge with a linear-register
            # error.
            ctrl_idxs = []
            bit_of = {}
            for j in range(size):
                ordinal = out.creg_map.get(off + j)
                if ordinal is None:
                    raise CircuitError(
                        f"Classical bit {creg}[{j}] is unmeasured; cannot "
                        f"lower the condition to a quantum control"
                    )
                qi = out.measurements[ordinal][0]
                if qi not in fresh:
                    raise CircuitError(
                        f"Source qubit of {creg}[{j}] was modified after its "
                        f"measurement; deferred-measurement lowering of "
                        f"{st!r} would be inexact"
                    )
                bit = (val >> j) & 1
                if qi in bit_of:
                    if bit_of[qi] != bit:
                        raise CircuitError(
                            f"Condition {st!r} is unsatisfiable: creg bits "
                            f"measured from the same source qubit q[{qi}] "
                            f"must compare equal, but {creg}=={val} requires "
                            f"them to differ"
                        )
                    continue
                bit_of[qi] = bit
                ctrl_idxs.append(qi)
            # Re-pack the compare value over the deduplicated control list.
            val = sum(bit_of[qi] << t for t, qi in enumerate(ctrl_idxs))
            itok = _TOKEN_RE.match(inner)
            if itok:
                inner_idxs = set(qubit_indices(itok.group("args")))
                overlap = inner_idxs & set(ctrl_idxs)
                if overlap:
                    raise CircuitError(
                        f"Condition targets its own source qubit(s) "
                        f"{sorted(overlap)} in {st!r} (e.g. the "
                        f"measure-then-'if (c==1) x q' active-reset idiom); "
                        f"deferred-measurement lowering cannot control a "
                        f"gate by its own target — use 'reset q' instead"
                    )
            ctrl_regs = [qubits[qi] for qi in ctrl_idxs]
            if any(r is None for r in ctrl_regs):
                raise CircuitError(f"Control qubit unavailable in {st!r}")
            for qi in ctrl_idxs:
                qubits[qi] = None
            cr = builder.merge_registers(ctrl_regs)
            cr = negate_bitmask(builder, cr, val)
            cb = builder.condition_with(cr)
            apply_statement(cb, inner)
            cr = cb.dissolve()
            cr = negate_bitmask(builder, cr, val)
            for qi, q in zip(ctrl_idxs, builder.split_all_register(cr)):
                qubits[qi] = q
                # X + controlled-op + X leaves the control's classical value
                # intact, so the measurement correspondence survives.
                fresh.add(qi)
            continue
        m = re.match(r"^qreg\s+([a-zA-Z_]\w*)\s*\[\s*(\d+)\s*\]$", st)
        if m:
            name, size = m.group(1), int(m.group(2))
            off = len(qubits)
            qreg_offsets[name] = (off, size)
            r = builder.register(size)
            qubits.extend(builder.split_all_register(r))
            continue
        m = re.match(r"^creg\s+([a-zA-Z_]\w*)\s*\[\s*(\d+)\s*\]$", st)
        if m:
            cregs[m.group(1)] = (n_c, int(m.group(2)))
            n_c += int(m.group(2))
            continue
        m = re.match(r"^reset\s+(?P<q>.+)$", st)
        if m:
            # Non-unitary reset = SWAP with a zeroed ancilla; the dirty
            # ancilla is retired (NOT returned to the temp pool), which
            # traces it out of every later measurement exactly.
            for qi in qubit_indices(m.group("q")):
                (q,) = take_slots([qi])
                tq = builder.make_zeroed_temp_qubit()
                q, _dirty = builder.swap_registers(q, tq)
                qubits[qi] = q
            continue
        m = re.match(
            r"^measure\s+(?P<q>[^\s]+)\s*->\s*(?P<c>[a-zA-Z_]\w*)"
            r"\s*(\[\s*(?P<ci>\d+)\s*\])?$",
            st,
        )
        if m:
            qis = qubit_indices(m.group("q"))
            if m.group("c") not in cregs:
                raise CircuitError(f"Unknown creg in {st!r}")
            c_off, c_size = cregs[m.group("c")]
            if m.group("ci") is None and len(qis) > c_size:
                raise CircuitError(f"creg too small in {st!r}")
            for pos, qi in enumerate(qis):
                ci = int(m.group("ci")) if m.group("ci") is not None else pos
                if ci >= c_size:
                    raise CircuitError(
                        f"creg bit {m.group('c')}[{ci}] out of range "
                        f"(size {c_size}) in {st!r}"
                    )
                qubits[qi], handle = builder.measure(qubits[qi])
                ordinal = len(out.measurements)
                out.measurements.append((qi, handle))
                fresh.add(qi)
                out.creg_map[c_off + ci] = ordinal
            continue
        apply_statement(builder, st)

    out.n = len(qubits)
    return out
