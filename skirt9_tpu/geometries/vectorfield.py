"""Vector fields: velocity / magnetic-field maps for geometric media.

Batched counterpart of the reference's VectorField family
(ref: SKIRT/core/VectorField.hpp:25 and the concrete classes
RadialVectorField.cpp, CylindricalVectorField.cpp,
HollowRadialVectorField.cpp, HubbleRadialVectorField.cpp,
UnidirectionalVectorField.cpp, plus the Rotate/Offset decorators).
Fields are evaluated host-side at spatial-grid cell centers during setup —
the per-cell vectors land in MediumTables.bulk_v (velocities, scaled by the
medium's velocityMagnitude) exactly as the reference samples fields into
the medium state (ref: GeometricMedium.hpp:34-44, MediumState bulkVelocity).

All evaluators are vectorized numpy: field(pos (N,3)) -> (N,3) with unit
(or normalized) magnitudes; callers multiply by the magnitude scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RadialVectorField:
    """Unit vectors away from the origin; magnitude a power law in radius
    saturating at 1 (ref: RadialVectorField.cpp vector())."""

    unity_radius: float = 0.0
    exponent: float = 0.0

    def field(self, pos: np.ndarray) -> np.ndarray:
        r = np.linalg.norm(pos, axis=-1)
        safe = np.maximum(r, 1e-300)
        u = pos / safe[:, None]
        v = np.ones_like(r)
        if self.unity_radius > 0.0:
            x = r / self.unity_radius
            if self.exponent > 0:
                v = np.where(r < self.unity_radius, x ** self.exponent, 1.0)
            elif self.exponent < 0:
                v = np.where(r > self.unity_radius, x ** self.exponent, 1.0)
        return np.where((r > 0)[:, None], v[:, None] * u, 0.0)


@dataclasses.dataclass(frozen=True)
class CylindricalVectorField:
    """Clockwise rotation around the z axis; magnitude a power law in the
    cylindrical radius (ref: CylindricalVectorField.cpp vector())."""

    unity_radius: float = 0.0
    exponent: float = 0.0

    def field(self, pos: np.ndarray) -> np.ndarray:
        u = np.stack([-pos[:, 1], pos[:, 0], np.zeros(len(pos))], axis=-1)
        r = np.linalg.norm(u, axis=-1)
        safe = np.maximum(r, 1e-300)
        u = u / safe[:, None]
        v = np.ones_like(r)
        if self.unity_radius > 0.0:
            x = r / self.unity_radius
            if self.exponent > 0:
                v = np.where(r < self.unity_radius, x ** self.exponent, 1.0)
            elif self.exponent < 0:
                v = np.where(r > self.unity_radius, x ** self.exponent, 1.0)
        return np.where((r > 0)[:, None], v[:, None] * u, 0.0)


@dataclasses.dataclass(frozen=True)
class HollowRadialVectorField:
    """Radial field that is zero inside zero_radius
    (ref: HollowRadialVectorField.cpp vector())."""

    zero_radius: float = 0.0
    exponent: float = 0.0

    def field(self, pos: np.ndarray) -> np.ndarray:
        r = np.linalg.norm(pos, axis=-1)
        safe = np.maximum(r, 1e-300)
        u = pos / safe[:, None]
        with np.errstate(invalid="ignore"):
            v = np.power(np.maximum(1.0 - self.zero_radius / safe, 0.0),
                         self.exponent)
        return np.where((r > self.zero_radius)[:, None], v[:, None] * u, 0.0)


@dataclasses.dataclass(frozen=True)
class HubbleRadialVectorField:
    """Linear rise to the turnover radius, linear decline to zero at the
    maximum radius (ref: HubbleRadialVectorField.cpp vector())."""

    turnover_radius: float
    max_radius: float

    def field(self, pos: np.ndarray) -> np.ndarray:
        r = np.linalg.norm(pos, axis=-1)
        safe = np.maximum(r, 1e-300)
        u = pos / safe[:, None]
        v = np.where(r <= self.turnover_radius, r / self.turnover_radius,
                     1.0 - (r - self.turnover_radius)
                     / max(self.max_radius - self.turnover_radius, 1e-300))
        ok = (r > 0) & (r <= self.max_radius)
        return np.where(ok[:, None], v[:, None] * u, 0.0)


@dataclasses.dataclass(frozen=True)
class UnidirectionalVectorField:
    """Constant unit field in a fixed direction
    (ref: UnidirectionalVectorField.cpp)."""

    direction: tuple = (0.0, 0.0, 1.0)

    def field(self, pos: np.ndarray) -> np.ndarray:
        d = np.asarray(self.direction, np.float64)
        d = d / np.linalg.norm(d)
        return np.broadcast_to(d, pos.shape).copy()


@dataclasses.dataclass(frozen=True)
class OffsetVectorFieldDecorator:
    """Evaluate the child field at pos - offset
    (ref: OffsetVectorFieldDecorator.hpp)."""

    child: object
    offset: tuple = (0.0, 0.0, 0.0)

    def field(self, pos: np.ndarray) -> np.ndarray:
        return self.child.field(pos - np.asarray(self.offset, np.float64))


def _euler_zxz(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Z-X-Z intrinsic Euler rotation matrix (the reference's convention,
    ref: RotateVectorFieldDecorator.hpp doc / HomogeneousTransform)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    Rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1.0]])
    Rx = np.array([[1.0, 0, 0], [0, cb, -sb], [0, sb, cb]])
    Rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1.0]])
    return Rz1 @ Rx @ Rz2


@dataclasses.dataclass(frozen=True)
class RotateVectorFieldDecorator:
    """Rotate the child field by Z-X-Z Euler angles: evaluate at the
    back-rotated position and rotate the resulting vector forward
    (ref: RotateVectorFieldDecorator.hpp)."""

    child: object
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0

    def field(self, pos: np.ndarray) -> np.ndarray:
        R = _euler_zxz(self.alpha, self.beta, self.gamma)
        v = self.child.field(pos @ R)  # pos @ R == R^T applied to rows
        return v @ R.T
