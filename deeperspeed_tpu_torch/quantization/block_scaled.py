"""``BlockScaledTensor``: one values+scales pairing for every wire and cache
(counterpart of ``deeperspeed_tpu/quantization/block_scaled.py``).

* symmetric per-group quantization along the last dim, ``x ~= q * scale``;
* dtype-parametric over ``int8`` / ``fp8_e4m3`` / ``fp8_e5m2`` (all one
  byte per element -- the fp8 dtypes trade the int8 grid for more dynamic
  range per block);
* a plain class holding two tensors (PyTorch needs no pytree registration);
* a canonical wire layout (``wire_payloads`` -> ``[values, fp32 scales]`` as
  numpy arrays): encode/decode is a memcpy.  numpy has no fp8 types, so fp8
  values travel as their raw bytes (``uint8``) and ``from_wire`` is told the
  dtype.

Whether a cast to fp8 saturates differs between frameworks and versions, so
``quantize`` clamps to the representable grid before every narrowing cast,
the same way the int8 path clamps to +-127.  With that, payload bytes and
scales equal the JAX package's bit for bit
(``tests/test_torch_block_scaled.py``).
"""

import numpy as np
import torch

#: canonical dtype name -> torch storage dtype (all 1 byte/element)
WIRE_DTYPES = {
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}

#: largest representable magnitude per wire dtype (symmetric grids: int8
#: uses +-127, fp8 the format's finfo max -- 448 for e4m3fn, 57344 for e5m2)
_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}

# 1 / qmax and the scale's epsilon as the fp32 constants the JAX
# package's compiled quantize multiplies and adds (see ``quantize``)
_RECIP = {k: float(np.float32(1.0 / v)) for k, v in _QMAX.items()}
_EPS = float(np.float32(1e-12))

_ALIASES = {
    "int8": "int8",
    "uint8": "int8",
    "fp8": "fp8_e4m3",
    "fp8_e4m3": "fp8_e4m3",
    "float8_e4m3fn": "fp8_e4m3",
    "e4m3": "fp8_e4m3",
    "fp8_e5m2": "fp8_e5m2",
    "float8_e5m2": "fp8_e5m2",
    "e5m2": "fp8_e5m2",
}


def canonical_dtype(dtype):
    """Canonical wire-dtype name for ``dtype`` (name, alias, torch or numpy
    dtype).  Raises ``ValueError`` for anything that is not a supported
    1-byte block-scaled storage type."""
    if isinstance(dtype, str):
        key = dtype.lower()
    elif isinstance(dtype, torch.dtype):
        key = str(dtype).split(".")[-1]
    else:
        try:
            key = np.dtype(dtype).name
        except TypeError:
            key = None
    name = _ALIASES.get(key)
    if name is None:
        raise ValueError(
            f"unsupported block-scaled wire dtype {dtype!r}; "
            f"expected one of {sorted(set(_ALIASES))}")
    return name


def wire_dtype(dtype):
    """The torch storage dtype for a canonical name / alias / dtype object."""
    return WIRE_DTYPES[canonical_dtype(dtype)]


def qmax(dtype):
    """Largest representable magnitude of ``dtype``'s symmetric grid."""
    return _QMAX[canonical_dtype(dtype)]


def group_shape(d, group_size):
    """Effective group length for a last dim of ``d``: ``group_size`` when
    it tiles ``d`` evenly, else one group spanning the whole row."""
    if group_size <= 0 or d % group_size != 0:
        return d
    return group_size


def block_shape_error(values_shape, scales_shape, group_size):
    """Explain how a (values, scales) pair violates the block layout, or
    ``None`` when consistent.  The contract: scales are
    ``values.shape[:-1] + (n_groups, 1)`` fp32 with ``n_groups =
    d / group_shape(d, group_size)``."""
    if not values_shape:
        return "values must have at least one dim"
    d = values_shape[-1]
    g = group_shape(d, group_size)
    want = tuple(values_shape[:-1]) + (d // g, 1)
    if tuple(scales_shape) != want:
        return (f"scales shape {tuple(scales_shape)} does not match values "
                f"{tuple(values_shape)} at group_size={group_size}: "
                f"expected {want}")
    return None


def _narrow(y, name):
    """Clamp ``y`` (fp32, already divided by scale) onto ``name``'s grid and
    cast.  int8 rounds half to even; fp8 casts carry their own rounding but
    are clamped first, so no value ever reaches a cast it could overflow."""
    limit = _QMAX[name]
    if name == "int8":
        return torch.clamp(torch.round(y), -limit, limit).to(torch.int8)
    return torch.clamp(y, -limit, limit).to(WIRE_DTYPES[name])


class BlockScaledTensor:
    """Quantized ``values [..., d]`` + per-block fp32 ``scales
    [..., d/group, 1]`` with ``x ~= dequantize()``.  The constructor never
    validates shapes; :func:`block_shape_error` states the contract."""

    __slots__ = ("values", "scales", "group_size")

    def __init__(self, values, scales, group_size=128):
        self.values = values
        self.scales = scales
        self.group_size = int(group_size)

    # ------------------------------------------------------------ views
    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        """Canonical wire-dtype name of the stored values."""
        return canonical_dtype(self.values.dtype)

    @property
    def wire_nbytes(self):
        """Bytes this tensor puts on a wire: 1B/element + 4B/scale."""
        return self.values.numel() + 4 * self.scales.numel()

    def __repr__(self):
        return (f"BlockScaledTensor({self.dtype}{list(self.shape)}, "
                f"group_size={self.group_size})")

    # ----------------------------------------------------- quant / dequant
    @classmethod
    def quantize(cls, x, dtype="int8", group_size=128):
        """Symmetric per-group quantization of ``x`` along its last dim.

        Scales are fp32 tensors whose values are snapped to the bf16 grid:
        every ``q * scale`` dequant product then fits fp32 exactly (<=8
        mantissa bits from q, <=8 from the scale), whatever the order or
        fusion of the sums that follow.

        The scale is rounded as the JAX package's compiled ``quantize``
        rounds ``amax / qmax + 1e-12``: XLA turns the division by the
        constant into a product with its fp32 reciprocal and contracts the
        product and the sum into one fused multiply-add, rounded once to
        fp32 and then to bf16.  Here that one rounding is taken from the
        exact fp64 product.  Requantizing a sum of dequantized values (the
        second hop of the two-level schedule) lands near a bf16 rounding
        edge often enough that a true division would give other scales.
        """
        name = canonical_dtype(dtype)
        d = x.shape[-1]
        g = group_shape(d, group_size)
        grouped = x.to(torch.float32).reshape(*x.shape[:-1], d // g, g)
        amax = grouped.abs().amax(dim=-1, keepdim=True)
        scale = (amax.to(torch.float64) * _RECIP[name] + _EPS).to(torch.float32).to(
            torch.bfloat16).to(torch.float32)
        q = _narrow(grouped / scale, name)
        return cls(q.reshape(x.shape), scale, group_size)

    def dequantize(self, dtype=torch.bfloat16):
        d = self.values.shape[-1]
        g = group_shape(d, self.group_size)
        grouped = self.values.to(torch.float32).reshape(
            *self.values.shape[:-1], d // g, g)
        out = grouped * self.scales.to(torch.float32)
        return out.reshape(self.values.shape).to(dtype)

    def cast(self, dtype):
        """Requantize onto another wire dtype (same block geometry)."""
        if canonical_dtype(dtype) == self.dtype:
            return self
        return type(self).quantize(self.dequantize(torch.float32), dtype,
                                   self.group_size)

    # ------------------------------------------- row layout (paged KV pool)
    # One group per row (group = the whole last dim) with the singleton
    # group axes squeezed away: values [..., d] + scales [...].  This is
    # the paged-KV pool layout -- scales live per (slot, head) beside the
    # block pool -- and the one place its scale math is defined.
    @classmethod
    def row_scale(cls, x, dtype="int8"):
        """Per-row fp32 scale: ``amax(|x|, last_dim) / qmax + eps``."""
        amax = x.to(torch.float32).abs().amax(dim=-1)
        return amax / _QMAX[canonical_dtype(dtype)] + 1e-12

    @classmethod
    def quantize_rows(cls, x, dtype="int8"):
        """``(q [..., d], fp32 scale [...])`` in the row layout."""
        name = canonical_dtype(dtype)
        scale = cls.row_scale(x, name)
        return _narrow(x.to(torch.float32) / scale[..., None], name), scale

    @staticmethod
    def dequantize_rows(q, scale, dtype=torch.bfloat16):
        out = q.to(torch.float32) * scale.to(torch.float32)[..., None]
        return out.to(dtype)

    @classmethod
    def from_rows(cls, q, scale):
        """View row-layout ``(q, scale)`` as a ``BlockScaledTensor``
        (group = whole last dim, scale axes re-expanded)."""
        return cls(q, scale.to(torch.float32)[..., None, None],
                   group_size=q.shape[-1])

    # ------------------------------------------------------------- wire
    def wire_payloads(self):
        """Canonical wire layout ``[values, scales]`` as host numpy arrays:
        int8 values as ``int8``, fp8 values as their raw bytes (``uint8``),
        scales as fp32.  Pure memcpy: no requantization on either end."""
        values = self.values
        if values.dtype != torch.int8:
            values = values.view(torch.uint8)
        return [values.cpu().numpy(), self.scales.cpu().numpy()]

    @classmethod
    def from_wire(cls, payloads, group_size=128, dtype=None):
        """Rebuild from ``wire_payloads`` output.  ``dtype`` names the wire
        dtype of raw-byte (``uint8``) values; int8 values need none."""
        values, scales = payloads
        values = torch.from_numpy(np.ascontiguousarray(values))
        if values.dtype == torch.uint8:
            if dtype is None:
                raise ValueError("from_wire: raw-byte values need their "
                                 "wire dtype (fp8_e4m3 or fp8_e5m2)")
            values = values.view(wire_dtype(dtype))
        return cls(values, torch.from_numpy(np.ascontiguousarray(scales)),
                   group_size)
