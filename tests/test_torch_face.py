"""The port's face helper and RetinaFace against the JAX package on the CPU.

``warp_affine`` computes ``map_coordinates(order=1, mode='constant')``'s
arithmetic (the same f32 products and sums over the four neighbours, zero
outside the image): 1e-6 absolute on [0, 1] images, the border included
(rows and columns that read partly or wholly outside the source). RetinaFace
through both weight routes (the JAX random init via ``convert/from_jax``; a
seeded ``Retinaface_mobilenet0.25.pth``-layout state dict via the port's
loader, which the JAX importer reads too): 1e-5 of max|JAX| in f32."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.utils import face_helper as jax_face
from instarevive_tpu.utils import retinaface as jax_retina
from instarevive_tpu_torch.convert import from_jax
from instarevive_tpu_torch.tools import iqa_checkpoints
from instarevive_tpu_torch.utils import face_helper, retinaface

WARP_BOUND = 1e-6
NET_BOUND = 1e-5


def landmarks(rng, scale=0.4, offset=(30, 40)):
    return face_helper.FFHQ_TEMPLATE_512 * scale + np.asarray(offset, np.float32) + rng.normal(0, 2, (5, 2)).astype(np.float32)


def test_umeyama_matches_jax():
    rng = np.random.default_rng(0)
    src = landmarks(rng)
    np.testing.assert_array_equal(face_helper.umeyama_similarity(src, face_helper.FFHQ_TEMPLATE_512),
                                  jax_face.umeyama_similarity(src, jax_face.FFHQ_TEMPLATE_512))


@pytest.mark.parametrize("out_hw", [(96, 80), (140, 150)])
def test_warp_affine_matches_map_coordinates(out_hw):
    """A rotation-and-scale whose output runs past every edge of the source."""
    rng = np.random.default_rng(1)
    img = rng.random((70, 90, 3), np.float32)
    c, s = 1.3 * np.cos(0.4), 1.3 * np.sin(0.4)
    m = np.array([[c, -s, 10.0], [s, c, -25.0]], np.float32)
    out = face_helper.warp_affine(torch.from_numpy(img), m, out_hw).numpy()
    ref = np.asarray(jax_face.warp_affine(jnp.asarray(img), m, out_hw))
    assert (ref == 0).any() and (ref > 0).any()  # the map leaves the source somewhere
    np.testing.assert_allclose(out, ref, rtol=0, atol=WARP_BOUND)


def test_align_paste_round_trip_matches_jax():
    """``FaceRestoreHelper`` with a stub detector: align two faces, paste
    edited crops back, against the JAX helper on the same landmarks."""
    rng = np.random.default_rng(2)
    img = rng.random((300, 260, 3), np.float32)
    marks = [landmarks(rng), landmarks(rng, 0.3, (120, 150))]

    def detector(im, conf_thresh=0.8):
        return np.zeros((2, 5), np.float32), np.stack(marks)

    helper = face_helper.FaceRestoreHelper(face_size=256, feather=20, detector=detector)
    ref_helper = jax_face.FaceRestoreHelper(face_size=256, feather=20, detector=detector)
    found = helper.get_face_landmarks_5(img)
    faces = helper.align_all(torch.from_numpy(img), found)
    ref_faces = ref_helper.align_all(jnp.asarray(img), ref_helper.get_face_landmarks_5(img))
    for f, r in zip(faces, ref_faces):
        np.testing.assert_allclose(f.numpy(), np.asarray(r), rtol=0, atol=WARP_BOUND)
    restored = [1.0 - f for f in faces]
    out = helper.paste_all(torch.from_numpy(img), restored)
    ref = ref_helper.paste_all(jnp.asarray(img), [1.0 - r for r in ref_faces])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=WARP_BOUND)
    assert not np.allclose(out.numpy(), img)  # the faces went back in


def test_helper_without_detector_raises():
    with pytest.raises(RuntimeError, match="no detector"):
        face_helper.FaceRestoreHelper().get_face_landmarks_5(np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("src,dst", [((5, 7), (13, 11)), ((4, 4), (8, 8))])
def test_upsample_rule_matches_jax(src, dst):
    x = np.random.default_rng(3).random((1, *src, 2), np.float32)
    out = retinaface._upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_retina._upsample_to(jnp.asarray(x), dst)))


@pytest.fixture(scope="module")
def nets():
    """{route: (port detector, JAX params)}."""
    jp = jax_retina.init_random_params(0)
    sd = iqa_checkpoints.retinaface(1)
    return {"from_jax": (retinaface.from_state_dict(from_jax.retinaface_params_to_torch(jp), "cpu"), jp),
            "official": (retinaface.from_state_dict(retinaface.state_dict_from_torch(sd), "cpu"),
                         jax_retina.params_from_torch(dict(sd)))}


@pytest.mark.parametrize("route", ["from_jax", "official"])
def test_retinaface_forward_matches_jax(nets, route):
    det, params = nets[route]
    img = np.random.default_rng(4).random((1, 96, 128, 3), np.float32) * 255 - 110
    with torch.no_grad():
        out = det.net(torch.from_numpy(img))
    for o, r in zip(out, jax.jit(jax_retina.retinaface_forward)(params, jnp.asarray(img))):
        r = np.asarray(r)
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= NET_BOUND * np.abs(r).max()


def test_retinaface_detection_matches_jax(nets):
    """Padding to multiples of 32, priors, decode, the threshold and NMS on a
    90x120 image."""
    det, params = nets["official"]
    img = np.random.default_rng(5).random((90, 120, 3), np.float32)
    faces, marks = det(img, conf_thresh=0.3)
    ref_faces, ref_marks = jax_retina.RetinaFace(params)(img, conf_thresh=0.3)
    assert len(faces) == len(ref_faces) > 0
    np.testing.assert_allclose(faces, ref_faces, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(marks, ref_marks, rtol=1e-4, atol=1e-3)


def test_retinaface_loader_raises():
    sd = iqa_checkpoints.retinaface(1)
    with pytest.raises(KeyError, match="ssh2.conv7x7_3.1.running_mean"):
        retinaface.state_dict_from_torch({k: v for k, v in sd.items() if k != "ssh2.conv7x7_3.1.running_mean"})
    with pytest.raises(KeyError, match="did not use.*body.stage4"):
        retinaface.state_dict_from_torch(dict(sd, **{"body.stage4.0.0.weight": torch.zeros(1)}))
