"""Pinhole camera as a dataclass of PyTorch tensors.

Port of ``tsdf_tpu/camera.py``; the conventions are the reference's:

* millimetres everywhere;
* ``k`` is [[fx, 0, cx], [0, fy, cy], [0, 0, 1]];
* ``pose`` is the 4x4 camera->world matrix, ``pose_inv`` its inverse;
* pixel x = column, pixel y = row; point batches end in a dimension of 3.

Every method returns a new camera; the tensors live on the device the
camera was made on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_F32 = torch.float32

# the reference's default depth camera (Camera::default_depth_camera)
DEFAULT_FX = 591.1
DEFAULT_FY = 590.1
DEFAULT_CX = 331.0
DEFAULT_CY = 234.6


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _homogeneous(xy: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 3) with a trailing 1."""
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """The same LU inverse as ``torch.linalg.inv``, without its host sync:
    ``inv`` copies the LU status to the host to check for a singular
    matrix, which on a card stalls the loop once per frame."""
    return torch.linalg.inv_ex(m).inverse


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics + extrinsics; all four matrices kept for reuse."""

    k: torch.Tensor  # (3, 3) f32
    k_inv: torch.Tensor  # (3, 3) f32
    pose: torch.Tensor  # (4, 4) f32, camera->world
    pose_inv: torch.Tensor  # (4, 4) f32, world->camera

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_intrinsics(fx, fy, cx, cy, pose=None, *, device) -> "Camera":
        k = torch.tensor(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
            dtype=_F32,
            device=device,
        )
        return Camera.from_k(k, pose, device=device)

    @staticmethod
    def default_depth_camera(pose=None, *, device) -> "Camera":
        return Camera.from_intrinsics(
            DEFAULT_FX, DEFAULT_FY, DEFAULT_CX, DEFAULT_CY, pose, device=device
        )

    @staticmethod
    def from_k(k, pose=None, *, device) -> "Camera":
        k = torch.as_tensor(k, dtype=_F32, device=device)
        if pose is None:
            pose = torch.eye(4, dtype=_F32, device=device)
        pose = torch.as_tensor(pose, dtype=_F32, device=device)
        return Camera(
            k=k,
            k_inv=_inv(k),
            pose=pose,
            pose_inv=_inv(pose),
        )

    @staticmethod
    def from_numpy(k, pose, k_inv=None, pose_inv=None, *, device) -> "Camera":
        """A camera from numpy matrices (e.g. the JAX camera's fields).
        The inverses are computed unless given, so passing all four
        reproduces another camera exactly."""

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        cam = Camera.from_k(t(k), t(pose), device=device)
        if k_inv is not None:
            cam = dataclasses.replace(cam, k_inv=t(k_inv))
        if pose_inv is not None:
            cam = dataclasses.replace(cam, pose_inv=t(pose_inv))
        return cam

    def to_numpy(self) -> dict:
        """The four matrices as numpy arrays, keyed by field name."""
        return {
            f.name: getattr(self, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(self)
        }

    @property
    def device(self) -> torch.device:
        return self.k.device

    # -- pose manipulation -------------------------------------------------

    def set_pose(self, pose) -> "Camera":
        pose = torch.as_tensor(pose, dtype=_F32, device=self.device)
        return dataclasses.replace(
            self, pose=pose, pose_inv=_inv(pose)
        )

    def move_to(self, xyz) -> "Camera":
        """Translate, keeping orientation."""
        pose = self.pose.clone()
        pose[0:3, 3] = torch.as_tensor(xyz, dtype=_F32, device=self.device)
        return self.set_pose(pose)

    def look_at(self, target) -> "Camera":
        """gluLookAt-style basis with +Y up; looking straight up or down
        takes the up vector from z. Pose columns become
        [left, up, forward] with forward = normalize(target - position)."""
        dev = self.device
        target = torch.as_tensor(target, dtype=_F32, device=dev)
        eps = 1e-6
        position = self.pose[0:3, 3]
        forward = _unit(target - position)
        straight = (forward[0].abs() < eps) & (forward[2].abs() < eps)
        up = torch.where(
            straight,
            torch.where(
                forward[1] < 0,
                torch.tensor([0.0, 0.0, 1.0], dtype=_F32, device=dev),
                torch.tensor([0.0, 0.0, -1.0], dtype=_F32, device=dev),
            ),
            torch.tensor([0.0, 1.0, 0.0], dtype=_F32, device=dev),
        )
        left = _unit(torch.linalg.cross(up, forward))
        up = _unit(torch.linalg.cross(forward, left))
        pose = torch.eye(4, dtype=_F32, device=dev)
        pose[0:3, 0] = left
        pose[0:3, 1] = up
        pose[0:3, 2] = forward
        pose[0:3, 3] = position
        return self.set_pose(pose)

    # -- accessors ---------------------------------------------------------

    @property
    def position(self) -> torch.Tensor:
        """Camera centre in world coordinates."""
        return self.pose[0:3, 3]

    @property
    def rotation(self) -> torch.Tensor:
        """Camera->world rotation block."""
        return self.pose[0:3, 0:3]

    # -- transforms (all broadcast over leading dims) ----------------------

    def _points(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=_F32, device=self.device)

    def pixel_to_image_plane(self, pixels) -> torch.Tensor:
        """(..., 2) pixels -> (..., 2) normalised image-plane coords."""
        pixels = self._points(pixels)
        cam = _homogeneous(pixels) @ self.k_inv.T
        return cam[..., 0:2] / cam[..., 2:3]

    def image_plane_to_pixel(self, coords) -> torch.Tensor:
        """(..., 2) image-plane coords -> (..., 2) rounded pixels."""
        coords = self._points(coords)
        img = _homogeneous(coords) @ self.k.T
        return torch.round(img[..., 0:2])

    def camera_to_world(self, points) -> torch.Tensor:
        """(..., 3) camera space -> world."""
        points = self._points(points)
        p = self.pose
        r = points @ p[0:3, 0:3].T + p[0:3, 3]
        w = points @ p[3, 0:3] + p[3, 3]
        return r / w[..., None]

    def world_to_camera(self, points) -> torch.Tensor:
        """(..., 3) world -> camera space."""
        points = self._points(points)
        pi = self.pose_inv
        r = points @ pi[0:3, 0:3].T + pi[0:3, 3]
        w = points @ pi[3, 0:3] + pi[3, 3]
        return r / w[..., None]

    def world_to_camera_normal(self, normals) -> torch.Tensor:
        """Rotate (..., 3) world normals into the camera frame."""
        return self._points(normals) @ self.pose_inv[0:3, 0:3].T

    def world_to_pixel(self, points) -> torch.Tensor:
        """(..., 3) world -> (..., 2) rounded pixels: K (pose_inv p),
        perspective divide, round, as the integrate kernels project."""
        img = self.world_to_camera(points) @ self.k.T
        return torch.round(img[..., 0:2] / img[..., 2:3])

    def camera_to_pixel(self, points) -> torch.Tensor:
        """(..., 3) camera space -> (..., 2) rounded pixels:
        K (x/z, y/z, 1). (The reference's device version reuses the
        updated x when computing y; the intended maths is kept.)"""
        points = self._points(points)
        img = points[..., 0:2] / points[..., 2:3]
        return torch.round((_homogeneous(img) @ self.k.T)[..., 0:2])

    def pixel_to_camera(self, pixels, depth) -> torch.Tensor:
        """(..., 2) pixels + (...,) depth -> (..., 3) camera-space points,
        depth * K^-1 (x, y, 1). K^-1's last row is (0, 0, 1), so z is
        the depth exactly."""
        pixels = self._points(pixels)
        depth = self._points(depth)
        plane = _homogeneous(pixels) @ self.k_inv.T
        return plane * depth[..., None]

    def pixel_to_world(self, pixels, depth) -> torch.Tensor:
        """(..., 2) pixels + (...,) depth -> (..., 3) world points."""
        return self.camera_to_world(self.pixel_to_camera(pixels, depth))

    # -- depth-map geometry ------------------------------------------------

    def depth_map_to_vertices(self, depth) -> tuple[torch.Tensor, torch.Tensor]:
        """(H, W) depth in mm -> ((H, W, 3) camera-space vertices, mask).
        A zero depth is invalid: its mask is False and its vertex 0."""
        depth = self._points(depth)
        h, w = depth.shape
        ys, xs = torch.meshgrid(
            torch.arange(h, device=self.device),
            torch.arange(w, device=self.device),
            indexing="ij",
        )
        pixels = torch.stack([xs, ys], dim=-1).to(_F32)
        verts = self.pixel_to_camera(pixels, depth)
        mask = depth > 0
        return torch.where(mask[..., None], verts, torch.zeros_like(verts)), mask
