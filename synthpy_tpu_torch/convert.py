"""Carry JAX-side state across to the port.

Functions here take what ``numpy.asarray`` makes of the JAX package's
arrays (no JAX import is needed) and return port objects on ``device``:
a ``TracePack``, ``ZScanPack`` or ``SegmentPack``, a ``ScalarDomain`` with
its fields, a key of ``synthpy_tpu_torch.random``, a proton ``BTable``, an
``OpacityLookup``, or a tensor (a JAX-drawn (9, N) ray bundle, for one).
bfloat16 arrives from ``np.asarray`` as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects; it is reinterpreted as 16-bit integers and
viewed as ``torch.bfloat16``, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.fields.domain import ScalarDomain, TracePack
from synthpy_tpu_torch.fields.forms import ClosedForm
from synthpy_tpu_torch.tracer.zscan import SegmentPack, ZScanPack

# the JAX ScalarDomain constructor whose closure an entry of
# domain.analytic is -> the port's closed form of it
_FORMS = {"test_null": "null", "test_slab": "slab",
          "test_linear_cos": "linear_cos",
          "test_exponential_cos": "exponential_cos", "test_lens": "lens",
          "test_liner": "liner", "test_B": "bz_linear"}


def tensor(a, device="cuda") -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` takes) as a tensor on
    ``device``, bfloat16 included, with its bits unchanged."""
    dev = _device.resolve(device)
    arr = np.array(a)   # a writable copy: JAX arrays export read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def trace_pack(jpack, device="cuda") -> TracePack:
    """A JAX ``TracePack`` as a port ``TracePack``: the channel grid on
    ``device``, the geometry as host numpy arrays."""
    return TracePack(tensor(jpack.channels, device),
                     np.array(jpack.origin), np.array(jpack.inv_spacing),
                     float(jpack.omega))


def zscan_pack(jzpack, device="cuda") -> ZScanPack:
    """A JAX ``ZScanPack`` as a port ``ZScanPack`` (same fields)."""
    return ZScanPack(tensor(jzpack.planes, device),
                     tensor(jzpack.origin_ab, device),
                     tensor(jzpack.inv_spacing_ab, device),
                     float(jzpack.p0), float(jzpack.dp), float(jzpack.omega))


def segment_pack(jpack, device="cuda") -> SegmentPack:
    """A JAX ``SegmentPack`` as a port ``SegmentPack`` (same fields). The
    JAX package's host form (a numpy ``seg_planes``, from
    ``build_segment_pack_streaming(device=False)``) becomes a port host
    pack: its table and scales stay in host memory, pinned when ``device``
    is a card."""
    dev = _device.resolve(device)
    host = isinstance(jpack.seg_planes, np.ndarray)

    def table(a):
        if not host:
            return tensor(a, dev)
        t = tensor(a, "cpu")
        return t.pin_memory() if dev.type == "cuda" else t

    scales = getattr(jpack, "scales", None)
    return SegmentPack(
        None if jpack.seg_planes is None else table(jpack.seg_planes),
        tensor(jpack.origin_ab, dev), tensor(jpack.inv_spacing_ab, dev),
        tuple(int(v) for v in jpack.shape_ab), int(jpack.K),
        int(jpack.n_slabs), float(jpack.p0), float(jpack.dp),
        float(jpack.omega), None if scales is None else table(scales),
        getattr(jpack, "qbits", None), host=host)


def key(jkey) -> torch.Tensor:
    """A JAX PRNG key, raw ((2,) uint32) or typed (``jax.random.key``), as
    the port's key (``synthpy_tpu_torch.random``): the same two words. A
    typed key's words are its ``_base_array``, read without importing
    JAX."""
    raw = getattr(jkey, "_base_array", jkey)
    words = np.array(raw).astype(np.int64).reshape(-1)
    if words.shape != (2,):
        raise ValueError("a threefry key has two uint32 words, got shape "
                         f"{np.shape(raw)}")
    return torch.from_numpy(words & 0xFFFFFFFF)


def closed_form(fn):
    """The port's ``ClosedForm`` of a closure that a JAX ``ScalarDomain``
    ``test_*`` constructor put in ``domain.analytic``, or None.

    It reads only the closure's qualified name
    (``ScalarDomain.test_lens.<locals>.<lambda>``) and the values of its
    free variables (``ne_0``, ``LR``, ...), which are the constructor's
    parameters; it runs nothing of JAX."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    parts = code.co_qualname.split(".")
    if (len(parts) != 4 or parts[0] != "ScalarDomain"
            or parts[2:] != ["<locals>", "<lambda>"]
            or parts[1] not in _FORMS):
        return None
    cells = fn.__closure__ or ()
    params = {name: float(c.cell_contents)
              for name, c in zip(code.co_freevars, cells)}
    return ClosedForm(_FORMS[parts[1]], **params)


def domain(jdomain, device="cuda") -> ScalarDomain:
    """A JAX ``ScalarDomain`` (coordinates, ne, Te, Z, B and the physics
    switches) as a port ``ScalarDomain``.

    ``jdomain.analytic`` comes across as the port's closed forms when
    every entry is a closure of a JAX ``test_*`` constructor
    (``closed_form``: ``ne`` of test_null, test_slab, test_linear_cos,
    test_exponential_cos, test_lens and test_liner, ``B`` of test_B), so
    the analytic solver runs on the converted domain. Any other closure is
    not guessed at: the port's domain then has ``analytic=None`` (set it
    to torch closures for the analytic solver)."""
    d = ScalarDomain(x=np.asarray(jdomain.x), y=np.asarray(jdomain.y),
                     z=np.asarray(jdomain.z), inv_brems=jdomain.inv_brems,
                     phaseshift=jdomain.phaseshift, B_on=jdomain.B_on,
                     probing_direction=jdomain.probing_direction,
                     device=device)
    for name in ("ne", "Te", "Z", "B"):
        v = getattr(jdomain, name)
        if v is not None:
            setattr(d, name, tensor(v, device).to(d.dtype))
    janalytic = getattr(jdomain, "analytic", None)
    if janalytic:
        forms = {k: closed_form(f) for k, f in janalytic.items()}
        if all(f is not None for f in forms.values()):
            d.analytic = forms
    return d


def b_table(jtab, device="cuda"):
    """A JAX ``BTable`` (``tracer.particles.build_B_table``) as the port's:
    the grid bit for bit (float32, bfloat16 or int8) and the int8 scales
    as float32, on ``device``."""
    from synthpy_tpu_torch.tracer.particles import BTable

    scale = None if jtab.scale is None else tensor(
        np.asarray(jtab.scale, np.float32), device)
    return BTable(tensor(jtab.grid, device), scale)


def opacity_lookup(jfn, device="cuda"):
    """The port's ``OpacityLookup`` of a lookup closure made by the JAX
    package's ``optics.xray.make_opacity_lookup``: it reads the closure's
    free variables (``T_grid``, ``rho_grid``, ``lt``, ``lr``, ``vals``,
    ``log_space``), as ``closed_form`` reads the ``test_*`` closures, and
    runs nothing of JAX. Raises ``ValueError`` for any other callable."""
    from synthpy_tpu_torch.optics.xray import OpacityLookup

    code = getattr(jfn, "__code__", None)
    if code is None or code.co_qualname != \
            "make_opacity_lookup.<locals>.lookup":
        raise ValueError("not a lookup made by the JAX package's "
                         "make_opacity_lookup")
    cells = dict(zip(code.co_freevars, jfn.__closure__ or ()))
    v = {k: c.cell_contents for k, c in cells.items()}

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    return OpacityLookup(f32(v["lt"]), f32(v["lr"]), f32(v["vals"]),
                         bool(v["log_space"]),
                         float(np.asarray(v["T_grid"])[0]),
                         float(np.asarray(v["rho_grid"])[0]),
                         _device.resolve(device))
