"""Fly-camera input controller.

A copy of `neural_renderer_tpu/cli/input_controller.py` (numpy only; this
package imports nothing of that one). WASD strafes in the camera basis,
Space/Ctrl (or Q/E) move along world up, shift doubles the speed,
mouse-look turns 0.1 degree per pixel with the pitch clamped to +-89
degrees. Explicit `apply_*` calls drive it, so the same controller serves
the viewer's window, scripted camera paths and tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

MOUSE_SENSITIVITY = 0.1   # deg per pixel
MAX_PITCH = 89.0
MAX_DELTA = 100.0         # ignore wild jumps (recapture events)


@dataclass
class CameraState:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = -90.0
    pitch: float = 0.0
    fov_y: float = 1.047198


@dataclass
class CameraBasis:
    forward: np.ndarray = field(default_factory=lambda: np.array([0, 0, -1.0], np.float32))
    right: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0], np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1.0, 0], np.float32))


class InputController:
    def __init__(self, camera: CameraState | None = None, move_speed: float = 1.0):
        self.camera = camera or CameraState()
        self.basis = CameraBasis()
        self.move_speed = move_speed
        self.update_basis()

    def set_move_speed(self, speed: float):
        self.move_speed = float(speed)

    def apply_mouse_delta(self, dx: float, dy: float):
        """dx: pixels right; dy: pixels up (GLFW convention is inverted —
        callers pass last_y - y)."""
        if abs(dx) > MAX_DELTA or abs(dy) > MAX_DELTA:
            return
        self.camera.yaw += dx * MOUSE_SENSITIVITY
        self.camera.pitch = float(np.clip(self.camera.pitch + dy * MOUSE_SENSITIVITY,
                                          -MAX_PITCH, MAX_PITCH))
        self.update_basis()

    def apply_keys(self, keys: set[str], dt: float):
        """keys: subset of {'w','s','a','d','space','ctrl','q','e','shift'}."""
        speed = self.move_speed * (2.0 if "shift" in keys else 1.0)
        delta = speed * dt
        world_up = np.array([0.0, 1.0, 0.0], np.float32)
        pos = self.camera.position.astype(np.float32)
        if "w" in keys:
            pos = pos + self.basis.forward * delta
        if "s" in keys:
            pos = pos - self.basis.forward * delta
        if "a" in keys:
            pos = pos - self.basis.right * delta
        if "d" in keys:
            pos = pos + self.basis.right * delta
        if "space" in keys or "e" in keys:
            pos = pos + world_up * delta
        if "ctrl" in keys or "q" in keys:
            pos = pos - world_up * delta
        self.camera.position = pos
        self.update_basis()

    def update_basis(self):
        yaw = math.radians(self.camera.yaw)
        pitch = math.radians(self.camera.pitch)
        forward = np.array([
            math.cos(pitch) * math.cos(yaw),
            math.sin(pitch),
            math.cos(pitch) * math.sin(yaw)], np.float32)
        forward /= np.linalg.norm(forward)
        world_up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(forward, world_up)
        rl = np.linalg.norm(right)
        right = np.array([1.0, 0.0, 0.0], np.float32) if rl < 1e-4 else right / rl
        up = np.cross(right, forward)
        up /= np.linalg.norm(up)
        self.basis = CameraBasis(forward=forward, right=right, up=up)
