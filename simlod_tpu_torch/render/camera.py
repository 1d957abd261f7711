"""Camera + orbit controls (host-side math, numpy float64).

Reproduces the reference viewing pipeline:
  - GL perspective projection, fovy in degrees, near 0.1 / far 2e6
    (GLRenderer.h:130-164)
  - orbit controls: world = T(target) @ Rz(yaw) @ Rx(pitch) @ flip @ T(0,0,radius),
    view = inverse(world) (OrbitControls.h:140-159; flip maps (x,y,z)->(x,-z,y), the
    Z-up convention)
All matrices act on COLUMN vectors [x, y, z, 1]; `transform = proj @ view @ world` is
exactly the reference's `uniforms.transform` (main_progressive_octree.cpp:283-297).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def perspective(fovy_deg: float, aspect: float, near: float = 0.1,
                far: float = 2_000_000.0) -> np.ndarray:
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def translate(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


# (x, y, z) -> (x, -z, y): the reference's Z-up flip (OrbitControls.h:152-157,
# column-major glm constructor)
FLIP = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


@dataclasses.dataclass
class OrbitControls:
    """Yaw/pitch/radius/target orbit model (reference OrbitControls.h:16-19)."""

    yaw: float = 0.0
    pitch: float = 0.0
    radius: float = 10.0
    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64))

    def world(self) -> np.ndarray:
        return (translate(self.target) @ rot_z(self.yaw) @ rot_x(self.pitch)
                @ FLIP @ translate([0.0, 0.0, self.radius]))

    # interaction math (reference OrbitControls.h:100-138)
    def rotate(self, dx_px: float, dy_px: float):
        self.yaw -= dx_px / 400.0
        self.pitch -= dy_px / 400.0

    def zoom(self, scroll: float):
        self.radius = self.radius * 1.1 if scroll < 0 else self.radius / 1.1

    def pan(self, dx_px: float, dy_px: float):
        w = self.world()
        local = np.array([-dx_px / 1000.0 * self.radius,
                          dy_px / 1000.0 * self.radius, 0.0, 0.0])
        self.target = self.target + (w @ local)[:3]

    def focus_box(self, box_min, box_max):
        """Auto-focus on a dataset box (the reference's autoFocusOnLoad behavior)."""
        box_min = np.asarray(box_min, np.float64)
        box_max = np.asarray(box_max, np.float64)
        self.target = 0.5 * (box_min + box_max)
        self.radius = float(np.linalg.norm(box_max - box_min)) * 1.2 + 1e-6
        self.yaw = -0.6
        self.pitch = -0.8


@dataclasses.dataclass
class Camera:
    """Perspective camera (reference GLRenderer.h:130-164)."""

    width: int = 1920
    height: int = 1080
    fovy: float = 60.0
    near: float = 0.1
    far: float = 2_000_000.0
    world: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def proj(self) -> np.ndarray:
        return perspective(self.fovy, self.aspect, self.near, self.far)

    def view(self) -> np.ndarray:
        return np.linalg.inv(self.world)

    def transform(self) -> np.ndarray:
        """proj @ view (scene world matrix is identity, as in the reference)."""
        return (self.proj() @ self.view()).astype(np.float32)
