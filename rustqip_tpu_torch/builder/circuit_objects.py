"""Pipeline circuit objects: the symbolic gate set the builder records.

Port of ``rustqip_tpu/builder/circuit_objects.py`` (host-only).

Mirrors the reference's ``BuilderCircuitObject``/``UnitaryMatrixObject``/
``MeasurementObject`` (``qip/src/builder.rs:101-290``): gates stay symbolic
(named gates, exact pi-rational rotations) until lowering, which keeps QASM
export exact and makes pipeline fingerprints cheap.

One deliberate extension over the reference: ``ControlledMatGate`` is a
first-class controlled arbitrary unitary — the reference leaves conditioning
a raw MAT unimplemented (``todo!()`` at builder.rs:808); here the engine's
Control op makes it native.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np

from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import Angle, PiRational

#: Self-inverse named single/two-qubit gates plus S/T.
NAMED_GATES = ("X", "Y", "Z", "H", "S", "T", "CNOT", "SWAP")


def _angle_fingerprint(theta: Angle):
    # Like the reference, floats are hashed via their string form
    # (builder.rs:223-225); PiRational hashes exactly.
    if isinstance(theta, PiRational):
        return ("pi_rational", theta.frac)
    return ("float", repr(float(theta)))


@dataclass(frozen=True)
class NamedGate:
    """X/Y/Z/H/S/T/CNOT/SWAP (ref UnitaryMatrixObject, builder.rs:131-147)."""

    name: str

    def __post_init__(self):
        if self.name not in NAMED_GATES:
            raise CircuitError(f"Unknown named gate {self.name!r}")

    def fingerprint(self):
        return ("named", self.name)


@dataclass(frozen=True)
class RzGate:
    """Rz by a float or exact pi-rational angle (ref builder.rs:148-149)."""

    theta: Angle

    def fingerprint(self):
        return ("rz", _angle_fingerprint(self.theta))


@dataclass(frozen=True)
class GlobalPhaseGate:
    """Global phase — no state effect unless conditioned
    (ref builder.rs:152-155)."""

    theta: Angle

    def fingerprint(self):
        return ("gphase", _angle_fingerprint(self.theta))


class MatGate:
    """Arbitrary dense unitary on n qubits (ref ``MAT``, builder.rs:150-151)."""

    __slots__ = ("data",)

    def __init__(self, data):
        arr = np.asarray(data, dtype=np.complex128)
        dim = int(round(np.sqrt(arr.size)))
        if dim * dim != arr.size or (dim & (dim - 1)) != 0:
            raise CircuitError(
                f"MAT data must be a 2^n x 2^n matrix, got {arr.size} entries"
            )
        self.data = arr.reshape(dim, dim)
        self.data.setflags(write=False)

    @property
    def n(self) -> int:
        return int(self.data.shape[0]).bit_length() - 1

    def fingerprint(self):
        return ("mat", self.data.tobytes())

    def __eq__(self, other):
        return isinstance(other, MatGate) and np.array_equal(self.data, other.data)

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        return f"MatGate(n={self.n})"


class SparseMatGate:
    """Arbitrary sparse unitary stored as per-row (col, val) entries —
    the builder-level oracle pathway (ref ``sparse_mat``,
    qip/src/builder.rs and ``SparseMatrixOpIterator``,
    qip-iterators/src/iterators/qubit_iterators.rs:60). Unlike dense MAT,
    it goes up to ``MAX_SPARSE_BITS`` (20) qubits: the engine applies it
    as gather passes, so >10-qubit classical oracles (Grover/Shor style)
    are one op.
    """

    __slots__ = ("rows",)

    def __init__(self, rows):
        self.rows = tuple(
            tuple((int(c), complex(v)) for c, v in row) for row in rows
        )
        dim = len(self.rows)
        if dim == 0 or (dim & (dim - 1)) != 0:
            raise CircuitError(
                f"Sparse MAT needs 2^n rows, got {dim}"
            )
        for rix, row in enumerate(self.rows):
            if not row:
                raise CircuitError(
                    f"All rows of sparse matrix must have data ({rix} empty)"
                )

    @property
    def n(self) -> int:
        return len(self.rows).bit_length() - 1

    def fingerprint(self):
        return ("smat", self.rows)

    def __eq__(self, other):
        return isinstance(other, SparseMatGate) and self.rows == other.rows

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        return f"SparseMatGate(n={self.n})"


class FnGate:
    """Function oracle gate: entries computed at apply time by
    ``fn(row) -> (col, val)``, elementwise over int32 torch tensors — the
    builder-level face of ``ops.matrix_ops.FnOp`` (the analog of the
    reference's lazy ``FunctionOpIterator``, qip-iterators/src/iterators/
    qubit_iterators.rs:223). Unlike ``SparseMatGate``, nothing is tabled:
    O(1) host memory at any width. ``tag`` is the structural identity
    (plan caching / fingerprints); ``self_transpose`` marks XOR-oracle
    structure, making the gate invertible via elementwise conjugation.
    """

    __slots__ = ("n_qubits", "fn", "tag", "conjugated", "self_transpose",
                 "diagonal")

    def __init__(self, n_qubits, fn, tag, conjugated=False,
                 self_transpose=False, diagonal=False):
        if n_qubits < 1:
            raise CircuitError("FnGate needs at least one qubit")
        self.n_qubits = int(n_qubits)
        self.fn = fn
        self.tag = str(tag)
        self.conjugated = bool(conjugated)
        self.self_transpose = bool(self_transpose) or bool(diagonal)
        self.diagonal = bool(diagonal)

    @property
    def n(self) -> int:
        return self.n_qubits

    def fingerprint(self):
        return ("fn", self.n_qubits, self.tag, self.conjugated,
                self.self_transpose, self.diagonal)

    def __eq__(self, other):
        return (
            isinstance(other, FnGate)
            and self.fingerprint() == other.fingerprint()
        )

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        return f"FnGate(n={self.n_qubits}, tag={self.tag!r})"


class ReflectionGate:
    """Reflection about the uniform superposition on its qubits:
    ``2|s><s| - I`` — the builder-level face of
    ``ops.matrix_ops.ReflectionOp``. A TPU-native composite with no
    reference analog (the reference composes Grover diffusion from
    ``2k`` Hadamards + X's + a multi-controlled Z; this gate is one
    reduction + one elementwise pass at any width, and one ``psum``
    under sharding). Real, symmetric, self-inverse."""

    __slots__ = ("n_qubits",)

    def __init__(self, n_qubits):
        if n_qubits < 1:
            raise CircuitError("ReflectionGate needs at least one qubit")
        self.n_qubits = int(n_qubits)

    @property
    def n(self) -> int:
        return self.n_qubits

    def fingerprint(self):
        return ("reflect", self.n_qubits)

    def __eq__(self, other):
        return (
            isinstance(other, ReflectionGate)
            and self.n_qubits == other.n_qubits
        )

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        return f"ReflectionGate(n={self.n_qubits})"


class ControlledMatGate:
    """n_ctrl-controlled arbitrary unitary — native controlled-MAT (the
    reference's missing case, builder.rs:808)."""

    __slots__ = ("n_ctrl", "mat")

    def __init__(self, n_ctrl: int, mat):
        if n_ctrl < 1:
            raise CircuitError("ControlledMatGate needs at least one control")
        self.n_ctrl = n_ctrl
        self.mat = mat

    def fingerprint(self):
        return ("cmat", self.n_ctrl, self.mat.fingerprint())

    def __eq__(self, other):
        return (
            isinstance(other, ControlledMatGate)
            and self.n_ctrl == other.n_ctrl
            and self.mat == other.mat
        )

    def __hash__(self):
        return hash(("cmat", self.n_ctrl, hash(self.mat)))


class RepeatBlock:
    """A recorded sub-pipeline applied ``times`` times.

    Extension with no reference analog: repeated structure (Grover rounds,
    Trotter steps) is planned ONCE and the planned body runs ``times``
    times — compile time O(body).
    The body must be purely unitary and must leave every qubit where it
    found it (net index permutation identity).
    """

    __slots__ = ("times", "body")

    def __init__(self, times: int, body):
        if times < 1:
            raise CircuitError("RepeatBlock needs times >= 1")
        self.times = times
        self.body = tuple(body)  # tuple of (indices, CircuitObject)

    def fingerprint(self):
        return (
            "repeat",
            self.times,
            tuple((idx, co.fingerprint()) for idx, co in self.body),
        )

    def __eq__(self, other):
        return (
            isinstance(other, RepeatBlock)
            and self.times == other.times
            and self.body == other.body
        )

    def __hash__(self):
        return hash(self.fingerprint())


UnitaryObject = Union[
    NamedGate, RzGate, GlobalPhaseGate, MatGate, SparseMatGate,
    FnGate, ReflectionGate, ControlledMatGate, RepeatBlock,
]


@dataclass(frozen=True)
class MeasurementObject:
    """Collapsing or stochastic measurement (ref builder.rs:284-290)."""

    stochastic: bool = False

    def fingerprint(self):
        return ("measure", self.stochastic)


class CircuitObject:
    """A pipeline object: arity + unitary-or-measurement
    (ref ``BuilderCircuitObject``, builder.rs:101-127)."""

    __slots__ = ("n", "obj")

    def __init__(self, n: int, obj: Union[UnitaryObject, MeasurementObject]):
        self.n = n
        self.obj = obj

    @property
    def is_measurement(self) -> bool:
        return isinstance(self.obj, MeasurementObject)

    def fingerprint(self):
        return (self.n, self.obj.fingerprint())

    def __eq__(self, other):
        return (
            isinstance(other, CircuitObject)
            and self.n == other.n
            and self.obj == other.obj
        )

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        return f"CircuitObject(n={self.n}, {self.obj!r})"


def _neg(theta: Angle) -> Angle:
    return -theta if isinstance(theta, PiRational) else -float(theta)


def invert_circuit_object(co: CircuitObject) -> List[CircuitObject]:
    """Inverse of one pipeline object, as a sequence applied in order
    (ref ``invert_circuit_object``, builder.rs:923-967).

    S^-1 = S.Z and T^-1 = T.S.Z are emitted as gate sequences so the
    inverted circuit stays within the symbolic gate set.
    """
    obj = co.obj
    if isinstance(obj, MeasurementObject):
        raise CircuitError("Cannot invert measurement.")
    if isinstance(obj, NamedGate):
        if obj.name in ("X", "Y", "Z", "H", "CNOT", "SWAP"):
            seq: List[UnitaryObject] = [obj]
        elif obj.name == "S":
            seq = [NamedGate("Z"), obj]
        elif obj.name == "T":
            seq = [NamedGate("Z"), NamedGate("S"), obj]
        else:  # pragma: no cover
            raise CircuitError(f"Unknown named gate {obj.name}")
    elif isinstance(obj, RzGate):
        seq = [RzGate(_neg(obj.theta))]
    elif isinstance(obj, GlobalPhaseGate):
        seq = [GlobalPhaseGate(_neg(obj.theta))]
    elif isinstance(obj, MatGate):
        seq = [MatGate(obj.data.conj().T)]
    elif isinstance(obj, SparseMatGate):
        from rustqip_tpu_torch.utils import transpose_sparse

        rows = transpose_sparse([list(r) for r in obj.rows])
        seq = [
            SparseMatGate(
                [[(c, complex(v).conjugate()) for c, v in r] for r in rows]
            )
        ]
    elif isinstance(obj, FnGate):
        if not obj.self_transpose:
            raise CircuitError(
                "Cannot invert a general function gate (its inverse "
                "needs the transposed column map); XOR-structured oracles "
                "(apply_function_op / self_transpose=True) invert via "
                "elementwise conjugation."
            )
        seq = [
            FnGate(obj.n_qubits, obj.fn, obj.tag, not obj.conjugated,
                   True, obj.diagonal)
        ]
    elif isinstance(obj, ReflectionGate):
        seq = [obj]  # self-inverse
    elif isinstance(obj, ControlledMatGate):
        if isinstance(obj.mat, ReflectionGate):
            seq = [obj]  # self-inverse inner => self-inverse control
        elif isinstance(obj.mat, (SparseMatGate, FnGate)):
            (inner,) = invert_circuit_object(
                CircuitObject(obj.mat.n, obj.mat)
            )
            seq = [ControlledMatGate(obj.n_ctrl, inner.obj)]
        else:
            seq = [
                ControlledMatGate(obj.n_ctrl, MatGate(obj.mat.data.conj().T))
            ]
    elif isinstance(obj, RepeatBlock):
        inv_body: List = []
        for indices, inner_co in reversed(obj.body):
            for inv_co in invert_circuit_object(inner_co):
                inv_body.append((indices, inv_co))
        seq = [RepeatBlock(obj.times, inv_body)]
    else:  # pragma: no cover
        raise CircuitError(f"Unknown circuit object {obj!r}")
    return [CircuitObject(co.n, o) for o in seq]


def flatten_pipeline(items):
    """Expand RepeatBlocks into their unrolled bodies (for replay/QASM)."""
    out = []
    for indices, co in items:
        if isinstance(co.obj, RepeatBlock):
            body = flatten_pipeline(co.obj.body)
            for _ in range(co.obj.times):
                out.extend(body)
        else:
            out.append((indices, co))
    return out


#: A recorded pipeline entry: (absolute qubit indices, object).
PipelineItem = Tuple[Tuple[int, ...], CircuitObject]
