"""DirectXMath-parity transform math on torch tensors, row-vector convention.

The reference builds its camera and model matrices with DirectXMath
(source/main.cpp:213-228, 368-375) and its shaders apply them as
``mul(float4(v, 1), M)``: the effective math is plain row-vector ``v @ M``,
matrices composing left to right.  The counterpart of
d3d12_deferred_renderer_tpu/xmath.py.

Every function works in float32 on the device of its tensor arguments, with
two choices that keep results identical across devices:

* matrix products are written out with a fixed summation order (``_mm``)
  instead of a BLAS call whose order and FMA use differ by backend;
* sin, cos and tan are evaluated in float64 and rounded once to float32, so
  the CPU and the GPU give the same correctly rounded values.
"""
from __future__ import annotations

import torch

__all__ = [
    "XM_PI",
    "XM_2PI",
    "XM_PIDIV4",
    "look_at_lh",
    "perspective_fov_lh",
    "rotation_roll_pitch_yaw",
    "scaling",
    "translation",
    "model_matrix",
    "normalize_safe",
    "matmul4",
    "matmul4_fma",
    "fma",
    "sinf",
    "rsqrtf",
    "powf",
    "divf",
]

XM_PI = 3.141592653589793
XM_2PI = 2.0 * XM_PI
XM_PIDIV4 = XM_PI / 4.0

F32 = torch.float32


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def _rounded(fn, a: torch.Tensor) -> torch.Tensor:
    return fn(a.to(torch.float64)).to(F32)


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] @ [..., 4, 4] with the sum taken as (p0 + p1) + (p2 + p3)."""
    p = [a[..., :, k, None] * b[..., None, k, :] for k in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding: the float64 product is exact and the
    float64 sum rounds once more before float32 (a double rounding that
    differs from a true fused multiply-add only on exact float64 ties)."""
    return (a.double() * b.double() + c.double()).float()


def matmul4_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] @ [..., 4, 4] rounded as XLA's CPU dot rounds it: the
    first product, then one fused multiply-add per further term, k = 1, 2,
    3 (the JAX package's ``a @ b``)."""
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, 4):
        acc = fma(a[..., :, k, None], b[..., None, k, :], acc)
    return acc


def sinf(x: torch.Tensor) -> torch.Tensor:
    """sin of float32 x, taken in float64 and rounded once: the correctly
    rounded value almost always, which XLA's float32 sin gives on about 99%
    of inputs (and within 1 ULP on the rest); the CUDA kernels take it the
    same way, so the plain versions and the kernels agree bit for bit."""
    return torch.sin(x.double()).float()


def rsqrtf(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) of float32 x, taken in float64 and rounded once (XLA's
    rsqrt is within 1 ULP of it); the CUDA kernels take it the same way."""
    return (1.0 / torch.sqrt(x.double())).float()


def powf(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e for float32 x, rounded as XLA rounds jnp.power: the exponent
    taken as a float32, the power evaluated in float64 and rounded once."""
    e32 = float(torch.tensor(e, dtype=F32))
    return torch.pow(x.double(), e32).float()


def divf(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b for a float32 tensor and a Python number, rounded once on every
    device.  torch on CUDA divides by a Python scalar as a multiply by its
    rounded reciprocal, up to 1 ULP off the quotient that the CPU, XLA and
    the CUDA kernels give; a divisor tensor on a's device divides."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis (length 3), rounded as XLA
    rounds jnp.linalg.norm: its reduction contracts into fused multiply-adds,
    sqrt(fma(z, z, fma(y, y, x * x))), and the square root is correctly
    rounded (taken in float64: torch's float32 sqrt on the CPU is not
    always)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()[..., None]


def normalize_safe(v: torch.Tensor) -> torch.Tensor:
    """Zero-guarded normalize over the last axis (length 3): a zero vector
    passes through unchanged."""
    n = _norm3(v)
    return v / torch.where(n == 0.0, torch.ones_like(n), n)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def look_at_lh(eye: torch.Tensor, at: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """XMMatrixLookAtLH: z = normalize(at - eye), x = normalize(up x z),
    y = z x x; translation row (-eye.x, -eye.y, -eye.z, 1)."""
    z = normalize_safe(at - eye)
    x = normalize_safe(_cross(up, z))
    y = _cross(z, x)
    zero = torch.zeros((), dtype=F32, device=eye.device)
    one = torch.ones((), dtype=F32, device=eye.device)
    return torch.stack([
        torch.stack([x[0], y[0], z[0], zero]),
        torch.stack([x[1], y[1], z[1], zero]),
        torch.stack([x[2], y[2], z[2], zero]),
        torch.stack([-_dot3(x, eye), -_dot3(y, eye), -_dot3(z, eye), one]),
    ])


def perspective_fov_lh(fov_y, aspect, z_near, z_far, device=None) -> torch.Tensor:
    """XMMatrixPerspectiveFovLH: h = cot(fov_y/2), w = h/aspect, clip z in
    [0, 1]; fRange = zf / (zf - zn) in float32 like DirectXMath."""
    fov = _f32(fov_y, device)
    h = 1.0 / _rounded(torch.tan, fov * 0.5)
    w = h / aspect
    zn = _f32(z_near, device)
    zf = _f32(z_far, device)
    zr = zf / (zf - zn)
    z0 = torch.zeros((), dtype=F32, device=device)
    z1 = torch.ones((), dtype=F32, device=device)
    return torch.stack([
        torch.stack([w, z0, z0, z0]),
        torch.stack([z0, h, z0, z0]),
        torch.stack([z0, z0, zr, z1]),
        torch.stack([z0, z0, -zr * zn, z0]),
    ])


def _rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot(a: torch.Tensor, axis: str) -> torch.Tensor:
    c, s = _rounded(torch.cos, a), _rounded(torch.sin, a)
    z0, z1 = torch.zeros_like(c), torch.ones_like(c)
    if axis == "x":
        return _rows([[z1, z0, z0, z0], [z0, c, s, z0], [z0, -s, c, z0], [z0, z0, z0, z1]])
    if axis == "y":
        return _rows([[c, z0, -s, z0], [z0, z1, z0, z0], [s, z0, c, z0], [z0, z0, z0, z1]])
    return _rows([[c, s, z0, z0], [-s, c, z0, z0], [z0, z0, z1, z0], [z0, z0, z0, z1]])


def rotation_roll_pitch_yaw(pitch, yaw, roll) -> torch.Tensor:
    """XMMatrixRotationRollPitchYaw: M = Rz(roll) @ Rx(pitch) @ Ry(yaw),
    batched over leading axes."""
    return matmul4(matmul4(_rot(roll, "z"), _rot(pitch, "x")), _rot(yaw, "y"))


def scaling(sx, sy, sz) -> torch.Tensor:
    z0, z1 = torch.zeros_like(sx), torch.ones_like(sx)
    return _rows([[sx, z0, z0, z0], [z0, sy, z0, z0], [z0, z0, sz, z0], [z0, z0, z0, z1]])


def translation(tx, ty, tz) -> torch.Tensor:
    z0, z1 = torch.zeros_like(tx), torch.ones_like(tx)
    return _rows([[z1, z0, z0, z0], [z0, z1, z0, z0], [z0, z0, z1, z0], [tx, ty, tz, z1]])


def model_matrix(position, orientation, scale) -> torch.Tensor:
    """Model matrix S @ R @ T (CalculateModelMatrix, main.cpp:368-375);
    [M, 3] each -> [M, 4, 4]; orientation is (pitch, yaw, roll)."""
    s = scaling(scale[..., 0], scale[..., 1], scale[..., 2])
    r = rotation_roll_pitch_yaw(
        orientation[..., 0], orientation[..., 1], orientation[..., 2]
    )
    t = translation(position[..., 0], position[..., 1], position[..., 2])
    return matmul4(matmul4(s, r), t)
