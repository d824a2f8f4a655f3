"""RetinaFace face detector, MobileNetV1-0.25 (the biubug6 graph facexlib
vendors): ``instarevive_tpu/utils/retinaface.py`` in PyTorch.

A MobileNet-0.25 body in three stages, a three-level FPN (nearest upsample
by the integer rule ``i * h // H``, as the JAX package indexes it, which
``F.interpolate`` does not reproduce at sizes that do not divide), an SSH
context module a level, and per-level class, box and landmark heads over two
anchors a position. Each convolution holds its BatchNorm folded in
(inference only). ``prior_boxes``, ``decode``, ``decode_landm`` and ``nms``
stay in numpy on the host.

Parameter names are those of ``Retinaface_mobilenet0.25.pth``, as
``state_dict_from_torch`` reads it (a folded conv takes the name of the
Sequential's conv); ``convert/from_jax.retinaface_params_to_torch`` maps the
JAX package's params. Plain torch ops.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import TakeKeys
from instarevive_tpu_torch.nn.layers import load_built

_LEAKY = 0.1
_OUT = 64  # FPN/SSH width of the 0.25 config
_MIN_SIZES = ((16, 32), (64, 128), (256, 512))
_STEPS = (8, 16, 32)
_VARIANCE = (0.1, 0.2)

# (kind, cin, cout, stride) of the body's stages; dw = depthwise + pointwise
_STAGE1 = [("conv", 3, 8, 2), ("dw", 8, 16, 1), ("dw", 16, 32, 2), ("dw", 32, 32, 1), ("dw", 32, 64, 2),
           ("dw", 64, 64, 1)]
_STAGE2 = [("dw", 64, 128, 2)] + [("dw", 128, 128, 1)] * 5
_STAGE3 = [("dw", 128, 256, 2), ("dw", 256, 256, 1)]
_SSH = (("conv3X3", _OUT, _OUT // 2), ("conv5X5_1", _OUT, _OUT // 4), ("conv5X5_2", _OUT // 4, _OUT // 4),
        ("conv7X7_2", _OUT // 4, _OUT // 4), ("conv7x7_3", _OUT // 4, _OUT // 4))
_HEADS = (("ClassHead", 4), ("BboxHead", 8), ("LandmarkHead", 20))


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups)


def _conv_bn(cin, cout, k=3, stride=1, groups=1) -> nn.Sequential:
    """A folded conv + BN under the checkpoint's Sequential index 0."""
    return nn.Sequential(_conv(cin, cout, k, stride, groups))


def _stage(spec) -> nn.Sequential:
    layers = []
    for kind, cin, cout, s in spec:
        if kind == "conv":
            layers.append(_conv_bn(cin, cout, 3, s))
        else:  # Sequential(dw conv, bn, leaky, pw conv, bn, leaky): the folded convs at 0 and 3
            layers.append(nn.Sequential(_conv(cin, cin, 3, s, groups=cin), nn.Identity(), nn.Identity(),
                                        _conv(cin, cout, 1)))
    return nn.Sequential(*layers)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _LEAKY)


def _upsample_to(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest upsample of NCHW ``x`` to ``hw``: source row i * h // H."""
    h, w = x.shape[2:]
    ridx = torch.arange(hw[0], device=x.device) * h // hw[0]
    cidx = torch.arange(hw[1], device=x.device) * w // hw[1]
    return x[:, :, ridx][:, :, :, cidx]


class RetinaFaceNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Module()
        self.body.stage1, self.body.stage2, self.body.stage3 = _stage(_STAGE1), _stage(_STAGE2), _stage(_STAGE3)
        self.fpn = nn.Module()
        for name, cin in (("output1", 64), ("output2", 128), ("output3", 256)):
            setattr(self.fpn, name, _conv_bn(cin, _OUT, 1))
        self.fpn.merge1, self.fpn.merge2 = _conv_bn(_OUT, _OUT), _conv_bn(_OUT, _OUT)
        for s in ("ssh1", "ssh2", "ssh3"):
            ssh = nn.Module()
            for name, cin, cout in _SSH:
                setattr(ssh, name, _conv_bn(cin, cout))
            setattr(self, s, ssh)
        for head, ch in _HEADS:
            heads = nn.ModuleList(nn.Module() for _ in range(3))
            for m in heads:
                m.conv1x1 = _conv(_OUT, ch, 1)
            setattr(self, head, heads)

    @staticmethod
    def _body(x: torch.Tensor, stage: nn.Sequential) -> torch.Tensor:
        for layer in stage:
            for conv in (layer[0], layer[3]) if len(layer) == 4 else (layer[0],):
                x = _leaky(conv(x))
        return x

    @staticmethod
    def _ssh(x: torch.Tensor, ssh: nn.Module) -> torch.Tensor:
        c3 = ssh.conv3X3[0](x)
        c51 = _leaky(ssh.conv5X5_1[0](x))
        c52 = ssh.conv5X5_2[0](c51)
        c72 = ssh.conv7x7_3[0](_leaky(ssh.conv7X7_2[0](c51)))
        return F.relu(torch.cat([c3, c52, c72], 1))

    def forward(self, img: torch.Tensor):
        """img: (B, H, W, 3) f32, BGR, mean-subtracted (104, 117, 123) ->
        (loc (B, N, 4), conf (B, N, 2) softmaxed, landms (B, N, 10)) over
        the three levels' priors."""
        x = img.permute(0, 3, 1, 2)
        f1 = self._body(x, self.body.stage1)
        f2 = self._body(f1, self.body.stage2)
        f3 = self._body(f2, self.body.stage3)
        o1, o2, o3 = (_leaky(getattr(self.fpn, f"output{i}")[0](f)) for i, f in ((1, f1), (2, f2), (3, f3)))
        o2 = _leaky(self.fpn.merge2[0](o2 + _upsample_to(o3, o2.shape[2:])))
        o1 = _leaky(self.fpn.merge1[0](o1 + _upsample_to(o2, o1.shape[2:])))
        feats = [self._ssh(o, getattr(self, f"ssh{i + 1}")) for i, o in enumerate((o1, o2, o3))]
        out = []
        for head, ch in _HEADS:
            per = [getattr(self, head)[i].conv1x1(f).permute(0, 2, 3, 1).reshape(f.shape[0], -1, ch // 2)
                   for i, f in enumerate(feats)]
            out.append(torch.cat(per, 1))
        loc, conf, landm = out[1], out[0], out[2]
        return loc, conf.softmax(-1), landm


def prior_boxes(h: int, w: int) -> np.ndarray:
    """Center-size anchors for an h x w input (biubug6 ``PriorBox``)."""
    anchors = []
    for sizes, step in zip(_MIN_SIZES, _STEPS):
        fh, fw = -(-h // step), -(-w // step)
        for i in range(fh):
            for j in range(fw):
                for ms in sizes:
                    anchors.append([(j + 0.5) * step / w, (i + 0.5) * step / h, ms / w, ms / h])
    return np.asarray(anchors, np.float32)


def decode(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """Center-size offsets -> (x1, y1, x2, y2) in [0, 1]."""
    v0, v1 = _VARIANCE
    cxy = priors[:, :2] + loc[:, :2] * v0 * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * v1)
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)


def decode_landm(landm: np.ndarray, priors: np.ndarray) -> np.ndarray:
    pts = landm.reshape(-1, 5, 2)
    return (priors[:, None, :2] + pts * _VARIANCE[0] * priors[:, None, 2:]).reshape(-1, 10)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> List[int]:
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= thresh]
    return keep


class RetinaFace:
    """Host-callable detector: (H, W, 3) RGB [0, 1] -> (faces (K, 5): box and
    score, landmarks (K, 5, 2)); the network runs on its own device."""

    _BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)

    def __init__(self, net: RetinaFaceNet):
        self.net = net.eval()

    @torch.no_grad()
    def __call__(self, img01: np.ndarray, conf_thresh: float = 0.8,
                 nms_thresh: float = 0.4) -> Tuple[np.ndarray, np.ndarray]:
        img01 = np.asarray(img01, np.float32)
        h, w = img01.shape[:2]
        ph, pw = -(-h // 32) * 32, -(-w // 32) * 32  # every FPN level exact
        x = img01[..., ::-1] * 255.0 - self._BGR_MEAN
        x = np.pad(x, ((0, ph - h), (0, pw - w), (0, 0)))
        dev = self.net.fpn.merge1[0].weight.device
        loc, conf, landm = (v[0].cpu().numpy() for v in self.net(torch.from_numpy(x)[None].to(dev)))
        priors = prior_boxes(ph, pw)
        boxes = decode(loc, priors) * [pw, ph, pw, ph]
        landms = decode_landm(landm, priors) * ([pw, ph] * 5)
        scores = conf[:, 1]
        keep = scores > conf_thresh
        boxes, landms, scores = boxes[keep], landms[keep], scores[keep]
        if len(boxes) == 0:
            return np.zeros((0, 5), np.float32), np.zeros((0, 5, 2), np.float32)
        idx = nms(boxes, scores, nms_thresh)
        out = np.concatenate([boxes[idx], scores[idx][:, None]], axis=1)
        return out.astype(np.float32), landms[idx].reshape(-1, 5, 2).astype(np.float32)


def _fold(src: TakeKeys, conv: str, bn: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm ``bn`` (eps 1e-5) folded into the bias-free conv ``conv``,
    in f32 as the JAX importer folds it."""
    w = torch.as_tensor(src.take(f"{conv}.weight")).float()
    g, b, m, v = (torch.as_tensor(src.take(f"{bn}.{leaf}")).float()
                  for leaf in ("weight", "bias", "running_mean", "running_var"))
    s = g / torch.sqrt(v + 1e-5)
    return w * s[:, None, None, None], b - m * s


def state_dict_from_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``RetinaFaceNet``'s state dict from ``Retinaface_mobilenet0.25.pth``:
    each Sequential's conv at index i with the BatchNorm at i + 1 folded in,
    the heads' ``conv1x1`` as they are. Raises on a missing key or one not
    used (BatchNorm counters aside)."""
    src = TakeKeys(sd, "RetinaFace")
    out = {}
    with torch.device("meta"):  # names only
        layout = RetinaFaceNet().state_dict()
    for key in layout:
        mod, leaf = key.rsplit(".", 1)
        if mod.endswith("conv1x1"):
            out[key] = torch.as_tensor(src.take(key)).float()
        elif leaf == "weight":
            head, i = mod.rsplit(".", 1)
            out[key], out[f"{mod}.bias"] = _fold(src, mod, f"{head}.{int(i) + 1}")
    src.done(ignore=("num_batches_tracked",))
    return out


def from_state_dict(sd: Mapping[str, torch.Tensor], device="cuda") -> RetinaFace:
    """The detector with the weights of ``sd`` (the port's layout) on ``device``."""
    return RetinaFace(load_built(RetinaFaceNet, sd, device))
