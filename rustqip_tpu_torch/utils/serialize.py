"""Circuit serialization (the checkpoint/resume subsystem, SURVEY.md §5).

Port of ``rustqip_tpu/utils/serialize.py``: the JSON is the JAX package's,
character for character, so a text written by either package loads in the
other. A rebuilt builder lives on the ``device`` its caller names.

The reference's persistence story is "the pipeline is plain data"
(``Subcircuitable::make_subcircuit``, builder.rs:828-842) plus QASM text
export. Here the pipeline round-trips through JSON — including arbitrary
matrices, exact pi-rational angles, and repeat blocks — so circuits can be
saved, shipped, and replayed; amplitude snapshots save via numpy (the
state is just an array).
"""

from __future__ import annotations

import json

import numpy as np

from rustqip_tpu_torch.builder.circuit_objects import (
    CircuitObject,
    ControlledMatGate,
    FnGate,
    GlobalPhaseGate,
    MatGate,
    MeasurementObject,
    NamedGate,
    PipelineItem,
    ReflectionGate,
    RepeatBlock,
    RzGate,
    SparseMatGate,
)
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import PiRational


def _angle_to_json(theta):
    if isinstance(theta, PiRational):
        return {"pi_rational": [theta.numerator, theta.denominator]}
    return {"float": float(theta)}


def _angle_from_json(d):
    if "pi_rational" in d:
        num, den = d["pi_rational"]
        return PiRational(int(num), int(den))
    return float(d["float"])


def _mat_to_json(data: np.ndarray):
    return {
        "shape": list(data.shape),
        "re": np.real(data).reshape(-1).tolist(),
        "im": np.imag(data).reshape(-1).tolist(),
    }


def _mat_from_json(d) -> np.ndarray:
    re = np.asarray(d["re"], dtype=np.float64)
    im = np.asarray(d["im"], dtype=np.float64)
    return (re + 1j * im).reshape(d["shape"])


def _sparse_to_json(rows):
    return [
        [[int(c), float(v.real), float(v.imag)] for c, v in row]
        for row in rows
    ]


def _sparse_from_json(rows):
    return [
        [(int(c), complex(re, im)) for c, re, im in row] for row in rows
    ]


def _obj_to_json(co: CircuitObject):
    obj = co.obj
    if isinstance(obj, NamedGate):
        body = {"kind": "named", "name": obj.name}
    elif isinstance(obj, RzGate):
        body = {"kind": "rz", "theta": _angle_to_json(obj.theta)}
    elif isinstance(obj, GlobalPhaseGate):
        body = {"kind": "global_phase", "theta": _angle_to_json(obj.theta)}
    elif isinstance(obj, MatGate):
        body = {"kind": "mat", "data": _mat_to_json(obj.data)}
    elif isinstance(obj, SparseMatGate):
        body = {"kind": "smat", "rows": _sparse_to_json(obj.rows)}
    elif isinstance(obj, ReflectionGate):
        body = {"kind": "reflect"}
    elif isinstance(obj, ControlledMatGate):
        if isinstance(obj.mat, ReflectionGate):
            body = {
                "kind": "creflect",
                "n_ctrl": obj.n_ctrl,
                "n_target": obj.mat.n,
            }
        elif isinstance(obj.mat, FnGate):
            raise CircuitError(
                f"Cannot serialize controlled function gate "
                f"{obj.mat.tag!r}: its entries are a Python callable "
                "evaluated at apply time, not data."
            )
        elif isinstance(obj.mat, SparseMatGate):
            body = {
                "kind": "csmat",
                "n_ctrl": obj.n_ctrl,
                "rows": _sparse_to_json(obj.mat.rows),
            }
        else:
            body = {
                "kind": "cmat",
                "n_ctrl": obj.n_ctrl,
                "data": _mat_to_json(obj.mat.data),
            }
    elif isinstance(obj, MeasurementObject):
        body = {"kind": "measure", "stochastic": obj.stochastic}
    elif isinstance(obj, RepeatBlock):
        body = {
            "kind": "repeat",
            "times": obj.times,
            "body": [_item_to_json(item) for item in obj.body],
        }
    elif isinstance(obj, FnGate):
        raise CircuitError(
            f"Cannot serialize function gate {obj.tag!r}: its "
            "entries are a Python callable evaluated at apply time, not data. "
            "For a serializable oracle use apply_sparse_matrix_from_"
            "function (table-based) or re-register the callable on load."
        )
    else:  # pragma: no cover
        raise CircuitError(f"Cannot serialize {obj!r}")
    body["n"] = co.n
    return body


def _obj_from_json(d) -> CircuitObject:
    kind = d["kind"]
    if kind == "named":
        obj = NamedGate(d["name"])
    elif kind == "rz":
        obj = RzGate(_angle_from_json(d["theta"]))
    elif kind == "global_phase":
        obj = GlobalPhaseGate(_angle_from_json(d["theta"]))
    elif kind == "mat":
        obj = MatGate(_mat_from_json(d["data"]))
    elif kind == "smat":
        obj = SparseMatGate(_sparse_from_json(d["rows"]))
    elif kind == "cmat":
        obj = ControlledMatGate(int(d["n_ctrl"]), MatGate(_mat_from_json(d["data"])))
    elif kind == "csmat":
        obj = ControlledMatGate(
            int(d["n_ctrl"]), SparseMatGate(_sparse_from_json(d["rows"]))
        )
    elif kind == "reflect":
        obj = ReflectionGate(int(d["n"]))
    elif kind == "creflect":
        obj = ControlledMatGate(
            int(d["n_ctrl"]), ReflectionGate(int(d["n_target"]))
        )
    elif kind == "measure":
        obj = MeasurementObject(bool(d["stochastic"]))
    elif kind == "repeat":
        obj = RepeatBlock(
            int(d["times"]), [_item_from_json(i) for i in d["body"]]
        )
    else:
        raise CircuitError(f"Unknown circuit object kind {kind!r}")
    return CircuitObject(int(d["n"]), obj)


def _item_to_json(item: PipelineItem):
    indices, co = item
    return {"indices": list(indices), "obj": _obj_to_json(co)}


def _item_from_json(d) -> PipelineItem:
    return tuple(int(i) for i in d["indices"]), _obj_from_json(d["obj"])


def circuit_to_json(builder) -> str:
    """Serialize a builder's circuit (qubit count + pipeline) to JSON."""
    return json.dumps(
        {
            "version": 1,
            "n": builder.n,
            "measurements": builder._measurements,
            "pipeline": [_item_to_json(item) for item in builder.pipeline],
        }
    )


def builder_from_json(text: str, dtype=None, device="cuda", kernel_ok=None):
    """Reconstruct a LocalBuilder (pipeline + qubit count) from JSON, on
    ``device`` with the kernel policy ``kernel_ok`` (``LocalBuilder``'s).

    The rebuilt builder is ready for ``calculate_state*`` and compiles to
    the plan the original's pipeline gives; register handles are not part
    of the serialized form (they are build-time bookkeeping), so allocate
    fresh ones only for appended circuitry.
    """
    from rustqip_tpu_torch.builder.builder import LocalBuilder

    d = json.loads(text)
    if d.get("version") != 1:
        raise CircuitError(f"Unknown circuit version {d.get('version')}")
    b = LocalBuilder(dtype=dtype, device=device, kernel_ok=kernel_ok)
    b._n = int(d["n"])
    b.pipeline = [_item_from_json(i) for i in d["pipeline"]]
    # Measurement bookkeeping is derivable from the pipeline (measurements
    # cannot hide inside repeat blocks); deriving keeps old files loadable.
    kinds = [
        "stochastic" if co.obj.stochastic else "collapse"
        for _, co in b.pipeline
        if isinstance(co.obj, MeasurementObject)
    ]
    b._measurement_kinds = kinds
    b._measurements = len(kinds)
    return b


def save_circuit(builder, path) -> None:
    with open(path, "w") as f:
        f.write(circuit_to_json(builder))


def load_circuit(path, dtype=None, device="cuda", kernel_ok=None):
    with open(path) as f:
        return builder_from_json(f.read(), dtype=dtype, device=device,
                                 kernel_ok=kernel_ok)


def _host(x) -> np.ndarray:
    """A numpy array of ``x``; a torch tensor is copied off its device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path, state_re, state_im=None) -> None:
    """Amplitude snapshot: save (re, im) float arrays. Takes a complex
    array, or the engine's (re, im) planes (numpy or torch, on any
    device)."""
    if state_im is None:
        arr = _host(state_re)
        np.savez_compressed(path, re=np.real(arr), im=np.imag(arr))
    else:
        np.savez_compressed(path, re=_host(state_re), im=_host(state_im))


def load_state(path) -> np.ndarray:
    d = np.load(path)
    return d["re"] + 1j * d["im"]
