"""Checkpoint and resume (``lssp_tpu/utils/checkpoint.py``).

The reference has none; its solvers warm-restart from x (r0 = b − A·x,
reference src/solver-cg.cxx:59) and cache factorizations behind
``factored`` flags.  A checkpoint makes both durable: the iterate x, the
preconditioner (factors, level schedules, plans, hierarchies), the
``SolveInfo`` and any extras.

File format, version 2: the 8-byte magic ``LSSPCKPT``, then ``<II`` (the
format version, the crc32 of the body), then the body: ``<Q`` the length
of a JSON tree, the JSON tree (UTF-8), and the raw bytes of every array it
refers to.  JAX's version 1 is a pickle, and loading a pickle runs code
from the file; version 2 holds data only (ROADMAP C property 17).  The
tree tags:

- tensors and numpy arrays: dtype name, shape and the byte offset and
  length of their data (a bfloat16 tensor as its 16-bit patterns);
- dataclasses (their init fields), tuples, lists and dicts (any keys);
- None, booleans, numbers and strings; numpy scalars; torch and numpy
  dtypes;
- functions and ``functools.partial``\\ s, by qualified name.

A dataclass or a function is stored by ``module:qualname`` and, on load,
resolves only to a dataclass or a module-level function defined in a
module under ``lssp_tpu_torch.``: any other name raises ``ValueError``, so
loading runs no code the file names outside the package.  Every port
preconditioner is such a tree, except the ``user`` PC, whose apply is the
caller's function: saving it raises ``ValueError``.  A version-1 file and a
bare pickle (JAX's earlier format) are refused with a ``ValueError``: the
port does not unpickle.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import struct
import types
import zlib
from typing import Optional

import numpy as np
import torch

_MAGIC = b"LSSPCKPT"
FORMAT_VERSION = 2
_PACKAGE = "lssp_tpu_torch"


class _Writer:
    """Encodes a tree as JSON with the arrays' bytes collected alongside."""

    def __init__(self):
        self.chunks = []
        self.offset = 0

    def _raw(self, buf: bytes) -> dict:
        ref = {"offset": self.offset, "nbytes": len(buf)}
        self.chunks.append(buf)
        self.offset += len(buf)
        return ref

    def encode(self, obj):
        if obj is None or isinstance(obj, (bool, str)):
            return obj
        if isinstance(obj, (int, float)) and not isinstance(obj, np.generic):
            return {"float": repr(obj)} if isinstance(obj, float) else obj
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            name = str(t.dtype).replace("torch.", "")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return {"tensor": {"dtype": name, "shape": list(obj.shape),
                               **self._raw(t.numpy().tobytes())}}
        if isinstance(obj, np.ndarray):
            if obj.dtype == object:
                raise ValueError("checkpoint: object arrays cannot be saved")
            a = np.ascontiguousarray(obj)
            return {"ndarray": {"dtype": a.dtype.str, "shape": list(a.shape),
                                **self._raw(a.tobytes())}}
        if isinstance(obj, np.generic):
            return {"npscalar": {"dtype": obj.dtype.str, **self._raw(obj.tobytes())}}
        if isinstance(obj, torch.dtype):
            return {"torch_dtype": str(obj).replace("torch.", "")}
        if isinstance(obj, np.dtype):
            return {"np_dtype": obj.str}
        if isinstance(obj, torch.device):
            return {"device": str(obj)}
        if isinstance(obj, functools.partial):
            return {"partial": {"func": self.encode(obj.func),
                                "args": self.encode(tuple(obj.args)),
                                "keywords": self.encode(dict(obj.keywords))}}
        if isinstance(obj, types.FunctionType):
            return {"function": _qualified(obj, "function")}
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return {"dataclass": _qualified(type(obj), "dataclass"),
                    "fields": {f.name: self.encode(getattr(obj, f.name))
                               for f in dataclasses.fields(obj) if f.init}}
        if isinstance(obj, tuple):
            return {"tuple": [self.encode(v) for v in obj]}
        if isinstance(obj, list):
            return {"list": [self.encode(v) for v in obj]}
        if isinstance(obj, dict):
            return {"dict": [[self.encode(k), self.encode(v)] for k, v in obj.items()]}
        raise ValueError(f"checkpoint: cannot save a {type(obj).__name__} (only tensors, "
                         "numpy arrays, dataclasses, containers, scalars, strings, dtypes "
                         "and functions of lssp_tpu_torch)")


def _qualified(obj, kind: str) -> str:
    """``module:qualname`` of a package function or dataclass, checked to
    resolve back to ``obj``."""
    mod, qual = getattr(obj, "__module__", "") or "", getattr(obj, "__qualname__", "")
    if not (mod == _PACKAGE or mod.startswith(_PACKAGE + ".")) or "<" in qual:
        raise ValueError(
            f"checkpoint: the {kind} {mod}.{qual} is not a module-level {kind} of "
            f"{_PACKAGE}, so it cannot be stored by name (a 'user' preconditioner's "
            "apply is the caller's code: rebuild that PC after loading instead)")
    if _resolve(f"{mod}:{qual}", kind) is not obj:
        raise ValueError(f"checkpoint: {mod}:{qual} does not name this {kind}")
    return f"{mod}:{qual}"


def _resolve(name: str, kind: str):
    """The package function or dataclass ``module:qualname`` names; raises
    ``ValueError`` for anything else (no import outside the package)."""
    mod, _, qual = name.partition(":")
    if not (mod == _PACKAGE or mod.startswith(_PACKAGE + ".")) or not qual:
        raise ValueError(f"checkpoint names {name!r}, outside {_PACKAGE}: refusing to load")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part, None)
    ok = (isinstance(obj, type) and dataclasses.is_dataclass(obj) if kind == "dataclass"
          else isinstance(obj, types.FunctionType) and "." not in qual)
    if not ok:
        raise ValueError(f"checkpoint names {name!r}, not a {kind} of {_PACKAGE}")
    return obj


_TORCH_DTYPES = {str(d).replace("torch.", ""): d for d in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool, torch.complex64, torch.complex128)}


class _Reader:
    def __init__(self, raw: memoryview, device):
        self.raw = raw
        self.device = device

    def _bytes(self, ref):
        return self.raw[ref["offset"]:ref["offset"] + ref["nbytes"]]

    def decode(self, node):
        if node is None or isinstance(node, (bool, int, str)):
            return node
        if isinstance(node, list) or not isinstance(node, dict) or len(node) > 2:
            raise ValueError("checkpoint: malformed tree")
        tag, val = next(iter(node.items()))
        if tag == "float":
            return float(val)
        if tag == "tensor":
            dt = _TORCH_DTYPES[val["dtype"]]
            store = torch.int16 if dt == torch.bfloat16 else dt
            buf = bytearray(self._bytes(val))
            t = torch.frombuffer(buf, dtype=store) if buf else torch.empty(0, dtype=store)
            t = t.view(dt).reshape(val["shape"])
            return t.to(self.device) if self.device is not None else t
        if tag == "ndarray":
            a = np.frombuffer(self._bytes(val), dtype=np.dtype(val["dtype"]))
            return a.reshape(val["shape"]).copy()
        if tag == "npscalar":
            return np.frombuffer(self._bytes(val), dtype=np.dtype(val["dtype"]))[0]
        if tag == "torch_dtype":
            return _TORCH_DTYPES[val]
        if tag == "np_dtype":
            return np.dtype(val)
        if tag == "device":
            return torch.device(val)
        if tag == "partial":
            return functools.partial(self.decode(val["func"]), *self.decode(val["args"]),
                                     **self.decode(val["keywords"]))
        if tag == "function":
            return _resolve(val, "function")
        if tag == "dataclass":
            cls = _resolve(val, "dataclass")
            return cls(**{k: self.decode(v) for k, v in node["fields"].items()})
        if tag == "tuple":
            return tuple(self.decode(v) for v in val)
        if tag == "list":
            return [self.decode(v) for v in val]
        if tag == "dict":
            return {self.decode(k): self.decode(v) for k, v in val}
        raise ValueError(f"checkpoint: unknown tag {tag!r}")


def save_checkpoint(path: str, x=None, M=None, info=None, **extra) -> None:
    """Write a checkpoint: the iterate ``x`` (warm-restart state), the
    preconditioner ``M`` (its factors survive, so a resume skips the
    factorization), the ``SolveInfo`` and any extra trees (``b``, options,
    counters).  Raises ``ValueError`` on what cannot be stored by data
    alone (a ``user`` preconditioner, a lambda)."""
    w = _Writer()
    tree = w.encode({"x": x, "M": M, "info": info, "extra": extra})
    head = json.dumps(tree, separators=(",", ":")).encode("utf-8")
    body = struct.pack("<Q", len(head)) + head + b"".join(w.chunks)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<II", FORMAT_VERSION, zlib.crc32(body)))
        f.write(body)


def load_checkpoint(path: str, device=True) -> dict:
    """Read a checkpoint written by ``save_checkpoint``: a dict with keys
    ``x``, ``M``, ``info`` and the extras.  ``device``: True moves tensors
    to ``config.resolve_device(None)`` (the current CUDA device; raises
    without one), False keeps them on the CPU, a torch device (or its
    name) moves them there; numpy arrays stay numpy.

    Raises ``ValueError`` on a missing magic, a format version other than
    2 (JAX's version 1 and its bare pickles included: the port does not
    unpickle), a failed checksum, or a tree that names anything outside
    the package."""
    from lssp_tpu_torch.config import resolve_device
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC) + 8)
        if len(head) < len(_MAGIC) + 8 or not head.startswith(_MAGIC):
            if head[:1] == b"\x80":
                raise ValueError(f"{path!r} is a bare pickle (a pre-v1 lssp_tpu checkpoint): "
                                 "lssp_tpu_torch does not unpickle; re-create it")
            raise ValueError(f"{path!r} is not an lssp_tpu checkpoint (bad magic)")
        version, crc = struct.unpack("<II", head[len(_MAGIC):])
        if version != FORMAT_VERSION:
            extra = (" (a pickle, which lssp_tpu_torch does not unpickle)"
                     if version == 1 else "")
            raise ValueError(f"checkpoint {path!r} has format version {version}{extra}; this "
                             f"build reads version {FORMAT_VERSION}: re-create it")
        body = f.read()
    if zlib.crc32(body) != crc or len(body) < 8:
        raise ValueError(f"checkpoint {path!r} failed its integrity check (truncated or "
                         "corrupted); refusing to load")
    (nhead,) = struct.unpack("<Q", body[:8])
    tree = json.loads(body[8:8 + nhead].decode("utf-8"))
    if device is True:
        dev = resolve_device(None)
    elif device is False or device is None:
        dev = None
    else:
        dev = torch.device(device)
    payload = _Reader(memoryview(body)[8 + nhead:], dev).decode(tree)
    out = dict(payload.pop("extra", {}))
    out.update(payload)
    return out


def checkpointed_solve(A, b, path: str, every: int = 100, method="gmres",
                       pc: Optional[str] = "none", options=None, pc_options=None,
                       max_rounds: int = 1000, device=None):
    """Solve with periodic checkpointing: ``every`` iterations a round,
    ``path`` written after each; if ``path`` exists, resume from it (x and
    the factored preconditioner are restored, so neither the iterations
    nor the setup are repeated).  The stopping threshold is frozen once,
    from the original r0 (``tol0``, kept in the file), so later rounds do
    not re-derive rtol·‖r‖ from their smaller start residual.  Returns
    (x, SolveInfo) with ``nits`` the total over every round and resume.
    ``device``: as in ``solve``."""
    import os

    from lssp_tpu_torch import pc as pc_mod
    from lssp_tpu_torch.config import SolverOptions, resolve_device
    from lssp_tpu_torch.solvers.facade import solve

    device = resolve_device(device, b)
    opts = (options or SolverOptions()).resolved()
    x0, M = None, None
    done = 0
    tol0 = None
    if os.path.exists(path):
        ck = load_checkpoint(path, device=device)
        x0, M = ck["x"], ck["M"]
        done = int(ck.get("nits_done", 0))
        tol0 = ck.get("tol0")
    if M is None and pc not in (None, "none"):
        M = pc_mod.setup(A, pc, pc_options, device=device)
    if tol0 is None:
        bn = torch.as_tensor(b).detach().cpu().double().numpy()
        r0 = bn if x0 is None else bn - A.to_scipy() @ x0.detach().cpu().double().numpy()
        tol0 = float(max(opts.rtol * np.linalg.norm(r0), opts.atol,
                         opts.rbtol * np.linalg.norm(bn)))
    total = 0
    info = None
    for _ in range(max_rounds):
        round_opts = dataclasses.replace(opts, maxit=every, atol=tol0, rtol=0.0, rbtol=0.0)
        x0, info = solve(A, b, x0=x0, method=method, M=M, options=round_opts, reorder=None,
                         device=device)
        total = done + int(info.nits)
        save_checkpoint(path, x=x0, M=M, info=info, nits_done=total, tol0=tol0)
        if bool(info.converged) or int(info.nits) == 0:
            break
        done = total
    return x0, dataclasses.replace(info, nits=total)
