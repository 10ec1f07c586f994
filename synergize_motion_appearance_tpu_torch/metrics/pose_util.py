"""3D head-pose math of the pose-accuracy metric, in numpy (the port's
copy of the JAX package's metrics/pose_util.py; the reference's
metrics/norm_pose/utils/pose_util.py): perspective projection of the
mediapipe canonical face mesh, euler <-> matrix conversions
(extrinsic-xyz, degrees, scipy's ``Rotation.from_euler('xyz')``
convention) and pose-sequence smoothing, batched over a sequence.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "create_perspective_matrix",
    "euler_and_translation_to_matrix",
    "matrix_to_euler_and_translation",
    "project_points",
    "invert_projection",
    "project_points_with_trans",
    "smooth_pose_seq",
]

# mediapipe face-geometry camera constants (vertical FOV 63deg, near 1,
# far 10000, origin top-left so Y is flipped) — norm_pose/utils/
# pose_util.py:7-27 uses the same environment.
_FOV_DEG = 63.0
_NEAR = 1.0
_FAR = 10000.0


def create_perspective_matrix(aspect_ratio: float) -> np.ndarray:
    """Row-major flattened 4x4 perspective matrix for the mediapipe
    face-geometry camera (pose_util.py:7-27)."""
    f = 1.0 / np.tan(np.deg2rad(_FOV_DEG) / 2.0)
    denom = 1.0 / (_NEAR - _FAR)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect_ratio
    m[1, 1] = -f  # top-left origin -> flip Y
    m[2, 2] = (_NEAR + _FAR) * denom
    m[2, 3] = -1.0
    m[3, 2] = _FAR * _NEAR * denom
    return m.reshape(-1)


def _rot_xyz(euler_deg: np.ndarray) -> np.ndarray:
    """Extrinsic-xyz rotation matrix R = Rz @ Ry @ Rx from degrees
    (the `scipy.spatial.transform.Rotation.from_euler('xyz')`
    convention used by the reference)."""
    ex, ey, ez = np.deg2rad(np.asarray(euler_deg, dtype=np.float64))
    ca, sa = np.cos(ex), np.sin(ex)
    cb, sb = np.cos(ey), np.sin(ey)
    cc, sc = np.cos(ez), np.sin(ez)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rz @ ry @ rx


def euler_and_translation_to_matrix(euler_angles, translation_vector):
    """Degrees + translation -> homogeneous 4x4 (pose_util.py:97-106)."""
    m = np.eye(4)
    m[:3, :3] = _rot_xyz(euler_angles)
    m[:3, 3] = np.asarray(translation_vector, dtype=np.float64)
    return m


def matrix_to_euler_and_translation(matrix):
    """Homogeneous 4x4 -> (euler xyz degrees, translation)
    (pose_util.py:108-114). Inverse of `_rot_xyz`: for
    R = Rz@Ry@Rx, R[2,0] = -sin(ey), R[2,1]/R[2,2] = tan(ex),
    R[1,0]/R[0,0] = tan(ez)."""
    m = np.asarray(matrix, dtype=np.float64)
    r = m[:3, :3]
    t = m[:3, 3]
    ey = np.arcsin(np.clip(-r[2, 0], -1.0, 1.0))
    if abs(r[2, 0]) < 1.0 - 1e-10:
        ex = np.arctan2(r[2, 1], r[2, 2])
        ez = np.arctan2(r[1, 0], r[0, 0])
    else:  # gimbal lock: ey = +-90deg, split is degenerate; pick ex=0
        ex = 0.0
        ez = np.arctan2(-r[0, 1], r[1, 1])
    return np.rad2deg(np.array([ex, ey, ez])), t


def _perspective_T(image_shape) -> np.ndarray:
    return create_perspective_matrix(
        image_shape[1] / image_shape[0]
    ).reshape(4, 4).T


def _homogeneous(points: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [points, np.ones(points.shape[:-1] + (1,), points.dtype)], axis=-1
    )


def _pose_mats(pose_vectors: np.ndarray) -> np.ndarray:
    return np.stack([
        euler_and_translation_to_matrix(p[:3], p[3:])
        for p in np.asarray(pose_vectors)
    ])


def project_points(points_3d, transformation_matrix, pose_vectors,
                   image_shape):
    """Per-frame pose transform then perspective projection to [0,1]^2
    screen coords (pose_util.py:30-45), batched over the L frames."""
    P_T = _perspective_T(image_shape)
    pts = _homogeneous(np.asarray(points_3d, dtype=np.float64))  # (L,N,4)
    M = transformation_matrix @ _pose_mats(pose_vectors)  # (L,4,4)
    clip = np.einsum("lnk,ljk->lnj", pts, M) @ P_T
    ndc = clip[..., :2] / clip[..., 3:4]
    return ((ndc + 1.0) * 0.5).astype(np.float32)


def invert_projection(projected_points, transformation_matrix,
                      pose_vectors, image_shape):
    """Screen [0,1]^2 back to 3D model coordinates, lifting each screen
    point to the clip-space vector [x, y, 1, 1]. The reference's version
    (pose_util.py:47-76) builds a 3-vector against the 4x4 inverse
    projection and crashes — it is dead code (its import is commented
    out at cmp_pose_accuracy.py:3); this is the working fix."""
    P_inv_T = np.linalg.inv(_perspective_T(image_shape).T).T
    scr = np.asarray(projected_points, dtype=np.float64)
    ndc = scr * 2.0 - 1.0
    pts = np.concatenate(
        [ndc, np.ones(ndc.shape[:-1] + (2,), ndc.dtype)], axis=-1
    )  # (L,N,4): [x, y, 1, 1]
    M_inv = np.linalg.inv(transformation_matrix @ _pose_mats(pose_vectors))
    world = np.einsum("lnk,ljk->lnj", pts @ P_inv_T, M_inv)
    return (world[..., :3] / world[..., 3:4]).astype(np.float32)


def project_points_with_trans(points_3d, transformation_matrix,
                              image_shape):
    """Projection with a single shared transform (pose_util.py:77-95)."""
    P_T = _perspective_T(image_shape)
    pts = _homogeneous(np.asarray(points_3d, dtype=np.float64))
    clip = pts @ transformation_matrix.T @ P_T
    ndc = clip[..., :2] / clip[..., 3:4]
    return ((ndc + 1.0) * 0.5).astype(np.float32)


def smooth_pose_seq(pose_seq, window_size: int = 5):
    """Centered moving-average smoothing with shrinking edge windows
    (pose_util.py:116-123)."""
    seq = np.asarray(pose_seq)
    out = np.zeros_like(seq)
    half = window_size // 2
    for i in range(len(seq)):
        out[i] = seq[max(0, i - half):min(len(seq), i + half + 1)].mean(
            axis=0
        )
    return out
