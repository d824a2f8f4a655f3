"""Face restoration helper, align -> enhance -> paste back:
``instarevive_tpu/utils/face_helper.py`` in PyTorch.

Five landmarks are aligned to the 512x512 FFHQ template by a least-squares
similarity (``umeyama_similarity``, numpy), the face is warped out
(``warp_affine``: bilinear, zero outside the image, on the device), and a
restored face goes back through the inverse affine under a feathered mask
(eroded by ``feather`` pixels, blurred by ``ops/filters.gaussian_blur``).
Landmarks come from any detector, ``utils/retinaface.RetinaFace`` for one.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from instarevive_tpu_torch.ops.filters import gaussian_blur

# FFHQ 5-point template for 512x512
FFHQ_TEMPLATE_512 = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935], [201.26117, 371.41043],
     [313.08905, 371.15118]],
    dtype=np.float32,
)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The least-squares similarity transform taking ``src`` points to
    ``dst`` (cv2.estimateAffinePartial2D's model): a 2x3 affine."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    dd = np.diag([1.0, d])
    r = u @ dd @ vt
    scale = (s * np.diag(dd)).sum() / ((sc**2).sum() / len(src))
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = mu_d - scale * r @ mu_s
    return m.astype(np.float32)


def warp_affine(img: torch.Tensor, m: np.ndarray, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) warped by the 2x3 affine ``m`` (source -> destination) to
    ``out_hw``: each output pixel reads the source at the inverse map of its
    (x, y), bilinear over the four neighbours, a neighbour outside the image
    counting 0 (``map_coordinates(order=1, mode='constant')`` of the JAX
    package, the same arithmetic in f32)."""
    m3 = np.eye(3, dtype=np.float32)
    m3[:2] = m
    mi = torch.from_numpy(np.linalg.inv(m3)[:2].astype(np.float32)).to(img.device)
    h, w = out_hw
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    sx = mi[0, 0] * xs + mi[0, 1] * ys + mi[0, 2]
    sy = mi[1, 0] * xs + mi[1, 1] * ys + mi[1, 2]
    ih, iw = img.shape[:2]
    src = img.float()
    out = torch.zeros(h, w, img.shape[2], device=img.device)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    for yi, wy in ((y0, 1 - (sy - y0)), (y0 + 1, sy - y0)):
        for xi, wx in ((x0, 1 - (sx - x0)), (x0 + 1, sx - x0)):
            valid = (yi >= 0) & (yi < ih) & (xi >= 0) & (xi < iw)
            v = src[yi.clamp(0, ih - 1).long(), xi.clamp(0, iw - 1).long()]
            out = out + (wy * wx)[..., None] * torch.where(valid[..., None], v, 0.0)
    return out


def align_face(img: torch.Tensor, landmarks5: np.ndarray, face_size: int = 512) -> Tuple[torch.Tensor, np.ndarray]:
    """One face of (H, W, C) ``img`` aligned to the FFHQ template at
    ``face_size``; returns (face, affine)."""
    m = umeyama_similarity(landmarks5, FFHQ_TEMPLATE_512 * (face_size / 512.0))
    return warp_affine(img, m, (face_size, face_size)), m


def paste_face_back(img: torch.Tensor, face: torch.Tensor, m: np.ndarray, feather: int = 20) -> torch.Tensor:
    """``face`` warped back into ``img`` by the inverse of ``m`` under a
    mask eroded by ``feather`` pixels and blurred (kernel 2 * feather + 1,
    sigma feather / 2)."""
    h, w = img.shape[:2]
    m3 = np.eye(3, dtype=np.float32)
    m3[:2] = m
    m_inv = np.linalg.inv(m3)[:2]
    face_back = warp_affine(face, m_inv, (h, w))
    mask = torch.ones(face.shape[:2], device=face.device)
    if feather > 0:
        mask[:feather], mask[-feather:], mask[:, :feather], mask[:, -feather:] = 0, 0, 0, 0
        mask = gaussian_blur(mask[None, ..., None], 2 * feather + 1, feather / 2.0)[0]
    else:
        mask = mask[..., None]
    mask_back = warp_affine(mask, m_inv, (h, w)).clamp(0.0, 1.0)
    return img * (1 - mask_back) + face_back * mask_back


class FaceRestoreHelper:
    """Every face of an image: landmarks (from ``detector`` or given),
    aligned crops, and the restored crops pasted back."""

    def __init__(self, face_size: int = 512, feather: int = 20, detector=None):
        self.face_size = face_size
        self.feather = feather
        self.detector = detector  # e.g. utils.retinaface.RetinaFace
        self.affines: List[np.ndarray] = []

    def get_face_landmarks_5(self, img01, conf_thresh: float = 0.8):
        """(K,) landmark arrays (5, 2) of the faces ``detector`` finds."""
        if self.detector is None:
            raise RuntimeError("no detector attached: construct FaceRestoreHelper(detector=RetinaFace(...)) "
                               "or pass landmarks to align_all")
        _, landmarks = self.detector(np.asarray(img01), conf_thresh=conf_thresh)
        return list(landmarks)

    def align_all(self, img: torch.Tensor, all_landmarks: List[np.ndarray]) -> List[torch.Tensor]:
        faces = []
        self.affines = []
        for lm in all_landmarks:
            face, m = align_face(img, lm, self.face_size)
            faces.append(face)
            self.affines.append(m)
        return faces

    def paste_all(self, img: torch.Tensor, restored_faces) -> torch.Tensor:
        out = img
        for face, m in zip(restored_faces, self.affines):
            out = paste_face_back(out, face, m, self.feather)
        return out
