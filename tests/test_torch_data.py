"""The PyTorch port's data layer (COLMAP parsers and the native points3D
walker, PLY point clouds, the readers, camera loading, `Scene`, the
synthetic scene generator, pose utilities) against the JAX package on the
CPU.

Both packages read the same on-disk scenes: the JAX generator's 10-view
64x48 scene (as `tests/test_data.py` writes it) and Blender and DTU
fixtures the tests write themselves. Host-side records must be equal
bitwise; match bundles within 1e-6; the port's generator writes the same
COLMAP and match files as JAX's and images within one 8-bit step (it
renders with the port's tile path, JAX's with its dense oracle)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from scgaussian_tpu.data import camera_utils as jcu
from scgaussian_tpu.data import colmap as jcolmap
from scgaussian_tpu.data import ply as jply
from scgaussian_tpu.data import pose_utils as jpose
from scgaussian_tpu.data import readers as jreaders
from scgaussian_tpu.data import scene as jscene
from scgaussian_tpu.data import virtual_poses as jvp
from scgaussian_tpu.data.synthetic import generate_scene as j_generate_scene
from scgaussian_tpu_torch import native
from scgaussian_tpu_torch.data import camera_utils as tcu
from scgaussian_tpu_torch.data import colmap as tcolmap
from scgaussian_tpu_torch.data import ply as tply
from scgaussian_tpu_torch.data import pose_utils as tpose
from scgaussian_tpu_torch.data import readers as treaders
from scgaussian_tpu_torch.data import scene as tscene
from scgaussian_tpu_torch.data import virtual_poses as tvp
from scgaussian_tpu_torch.data.synthetic import generate_scene as t_generate_scene
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

SCENE = dict(n_views=10, n_gaussians=40, n_points=80, width=64, height=48)
CAMERA_FIELDS = ("uid", "R", "T", "fovy", "fovx", "image_path", "image_name", "width", "height",
                 "dtumask", "blendermask", "point3D_ids", "near_far")
BUNDLE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaxscene")
    j_generate_scene(str(d), **SCENE)
    return str(d)


def assert_equal(a, b, msg=""):
    if a is None or b is None:
        assert a is None and b is None, msg
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def assert_camera_infos_equal(tcams, jcams):
    assert len(tcams) == len(jcams)
    for tc, jc in zip(tcams, jcams):
        for f in CAMERA_FIELDS:
            assert_equal(getattr(tc, f), getattr(jc, f), f"{jc.image_name}.{f}")
        if jc.image is None:
            assert tc.image is None
        else:
            assert tc.image.size == jc.image.size
            assert_equal(np.array(tc.image), np.array(jc.image), f"{jc.image_name}.image")


def assert_scene_infos_equal(t, j):
    for f in ("train_cameras", "test_cameras", "base_cameras"):
        if getattr(j, f) is None:
            assert getattr(t, f) is None, f
        else:
            assert_camera_infos_equal(getattr(t, f), getattr(j, f))
    assert set(t.nerf_normalization) == set(j.nerf_normalization)
    for k in j.nerf_normalization:
        assert_equal(t.nerf_normalization[k], j.nerf_normalization[k], k)
    assert t.ply_path == j.ply_path
    if j.point_cloud is None:
        assert t.point_cloud is None
    else:
        for a, b in zip(t.point_cloud, j.point_cloud):
            assert_equal(a, b, "point_cloud")
    if j.match_data is None:
        assert t.match_data is None
    else:
        assert t.match_data.keys() == j.match_data.keys()
        for a in j.match_data:
            assert t.match_data[a].keys() == j.match_data[a].keys()
            for b in j.match_data[a]:
                assert_equal(t.match_data[a][b], j.match_data[a][b], f"match {a}->{b}")


def assert_bundles_close(tb, jb):
    assert (tb.width, tb.height) == (jb.width, jb.height)
    for f in ("rays_o", "rays_d", "cam_rays_d", "uv", "color", "mask", "near_far", "intr", "w2c"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                   err_msg=f, **BUNDLE_TOL)
    for f in ("pad_valid", "src", "dst", "partner", "pairs_of_view"):
        assert_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)


def assert_loaded_cameras_equal(tcams, jcams):
    assert [c.image_name for c in tcams] == [c.image_name for c in jcams]
    for tc, jc in zip(tcams, jcams):
        assert (tc.width, tc.height, tc.uid, tc.colmap_id) == (jc.width, jc.height, jc.uid,
                                                               jc.colmap_id)
        for f in ("R", "T", "fovx", "fovy", "image", "dtumask", "blendermask", "near_far"):
            assert_equal(getattr(tc, f), getattr(jc, f), f"{jc.image_name}.{f}")
        for f in ("world_view", "full_proj", "cam_center", "K"):
            np.testing.assert_allclose(getattr(tc.camera, f).numpy(),
                                       np.asarray(getattr(jc.camera, f)), rtol=1e-6, atol=1e-6,
                                       err_msg=f)
        assert tc.camera.device.type == "cpu"
        if jc.image is not None:
            assert_equal(tc.gt_image().numpy(), jc.image)


# ---------------- COLMAP files and point clouds ----------------

def test_points3d_native_and_python_paths_match_jax(jax_scene, monkeypatch):
    path = os.path.join(jax_scene, "sparse/0/points3D.bin")
    monkeypatch.setattr(jcolmap, "_points3d_native", lambda buf: None)
    want = jcolmap.read_points3D_binary_pointid(path)

    with open(path, "rb") as f:
        native_out = tcolmap._points3d_native(f.read())
    assert native_out is not None  # g++ builds the walker here, into build/native/
    assert native.load_library("colmap_fast") is not None
    assert any(p.name.startswith("colmap_fast-") for p in native.BUILD_DIR.glob("*.so"))
    reader_out = tcolmap.read_points3D_binary_pointid(path)
    monkeypatch.setattr(tcolmap, "_points3d_native", lambda buf: None)
    python_out = tcolmap.read_points3D_binary_pointid(path)
    for got in (native_out, reader_out, python_out):
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            assert_equal(a, b)
        assert got[3] == want[3]


def test_colmap_files_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    cams = {1: tcolmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.0, 501.0, 320, 240])),
            2: tcolmap.ColmapCamera(2, "SIMPLE_PINHOLE", 320, 240, np.array([250.0, 160, 120]))}
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    ims = {5: tcolmap.ColmapImage(5, q, np.array([0.1, 0.2, 0.3]), 1, "photo.png",
                                  rng.uniform(0, 100, (7, 2)), np.arange(7, dtype=np.int64))}
    xyz, rgb, err = rng.normal(size=(11, 3)), rng.integers(0, 255, (11, 3)), rng.uniform(size=11)
    for writer, reader, tag in ((tcolmap, jcolmap, "port->jax"), (jcolmap, tcolmap, "jax->port")):
        d = tmp_path / tag
        d.mkdir()
        writer.write_intrinsics_binary(str(d / "cameras.bin"), cams)
        writer.write_extrinsics_binary(str(d / "images.bin"), ims)
        writer.write_points3D_binary(str(d / "points3D.bin"), xyz, rgb, err)
        back = reader.read_intrinsics_binary(str(d / "cameras.bin"))
        for k in cams:
            assert back[k].model == cams[k].model
            assert_equal(back[k].params, cams[k].params)
        im = reader.read_extrinsics_binary(str(d / "images.bin"))[5]
        assert im.name == "photo.png"
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            assert_equal(getattr(im, f), getattr(ims[5], f), f)
        x2, r2, e2 = reader.read_points3D_binary(str(d / "points3D.bin"))
        assert_equal(x2, xyz)
        assert_equal(r2, rgb)
    for a, b in (("cameras.bin", "cameras.bin"), ("images.bin", "images.bin"),
                 ("points3D.bin", "points3D.bin")):
        assert (tmp_path / "port->jax" / a).read_bytes() == (tmp_path / "jax->port" / b).read_bytes()
    for _ in range(5):
        R = tcolmap.qvec2rotmat(rng.normal(size=4) / 2)
        assert_equal(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))


def test_colmap_text_readers_match_jax(tmp_path):
    cameras, images, points = (tmp_path / n for n in ("cameras.txt", "images.txt", "points3D.txt"))
    cameras.write_text("# camera list\n1 PINHOLE 64 48 50.5 51.5 32 24\n"
                       "2 SIMPLE_PINHOLE 32 24 20 16 12\n")
    images.write_text("# image list\n1 0.9 0.1 0.2 0.3 0.5 -0.25 1.5 1 a.png\n"
                      "10.5 20.25 3 11 12 -1\n2 1 0 0 0 0 0 0 2 b.png\n\n")
    points.write_text("# points\n3 0.5 1.5 4.0 10 20 30 0.25 1 0\n4 -0.5 1.0 5.0 1 2 3 0.5\n")
    for name, path in (("read_intrinsics_text", cameras), ("read_extrinsics_text", images)):
        t = getattr(tcolmap, name)(str(path))
        j = getattr(jcolmap, name)(str(path))
        assert t.keys() == j.keys()
        for k in j:
            for a, b in zip(t[k], j[k]):
                assert_equal(a, b, name)
    for a, b in zip(tcolmap.read_points3D_text(str(points)), jcolmap.read_points3D_text(str(points))):
        assert_equal(a, b)


def test_point_clouds_cross_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    xyz, rgb = rng.normal(size=(30, 3)), rng.uniform(0, 255, (30, 3))
    tply.store_point_cloud(str(tmp_path / "t.ply"), xyz, rgb)
    jply.store_point_cloud(str(tmp_path / "j.ply"), xyz, rgb)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for a, b in zip(tply.fetch_point_cloud(str(tmp_path / "j.ply")),
                    jply.fetch_point_cloud(str(tmp_path / "t.ply"))):
        assert_equal(a, b)


# ---------------- readers, camera loading, Scene ----------------

def test_colmap_scene_info_matches_jax(jax_scene):
    t = treaders.read_colmap_scene(jax_scene, "images", eval=True)
    j = jreaders.read_colmap_scene(jax_scene, "images", eval=True)
    assert [c.image_name for c in t.test_cameras] == ["img_000", "img_008"]
    assert [c.image_name for c in t.train_cameras] == ["img_001", "img_005", "img_009"]
    assert_scene_infos_equal(t, j)
    assert_scene_infos_equal(treaders.read_colmap_scene(jax_scene, "images", eval=False),
                             jreaders.read_colmap_scene(jax_scene, "images", eval=False))


def test_scene_cameras_and_bundle_match_jax(jax_scene, tmp_path):
    kw = dict(source_path=jax_scene, resolution=2, eval=True, shuffle=True, seed=3)
    t = tscene.Scene(model_path=str(tmp_path / "t"), device="cpu", **kw)
    j = jscene.Scene(model_path=str(tmp_path / "j"), **kw)
    assert t.kind == j.kind == "Colmap" and t.is_dtu is False
    assert t.cameras_extent == j.cameras_extent
    assert t.train_cameras[0].image.shape == (3, 24, 32)  # -r 2 resizes 64x48
    assert_loaded_cameras_equal(t.train_cameras, j.train_cameras)
    assert_loaded_cameras_equal(t.test_cameras, j.test_cameras)
    assert t.base_names == j.base_names
    assert [t.view_id(c) for c in t.train_cameras] == [j.view_id(c) for c in j.train_cameras]
    with open(tmp_path / "t" / "cameras.json") as ft, open(tmp_path / "j" / "cameras.json") as fj:
        assert json.load(ft) == json.load(fj)
    assert t.bundle.rays_o.device.type == "cpu"
    assert_bundles_close(t.bundle, j.bundle)
    for f in ("point_cloud_dir", "init_point_cloud_dir"):
        assert (os.path.relpath(getattr(t, f)(7), t.model_path)
                == os.path.relpath(getattr(j, f)(7), j.model_path))


def test_scene_resolves_the_gpu_by_default(jax_scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.Scene(jax_scene, str(tmp_path / "m"), resolution=2)


def test_blender_reader_and_bundle_match_jax(tmp_path):
    """Blender transforms: alpha compositing, the 8-view split, masks, and
    the bundle's warped masks."""
    d = tmp_path / "blenderscene"
    (d / "train").mkdir(parents=True)
    (d / "test").mkdir()
    rng = np.random.default_rng(0)

    def make_frames(split, n):
        frames = []
        for i in range(n):
            img = (rng.uniform(0, 255, (32, 32, 4))).astype(np.uint8)
            img[:10, :, 3] = 0  # transparent band
            Image.fromarray(img, "RGBA").save(d / split / f"r_{i}.png")
            c2w = np.eye(4)
            c2w[2, 3] = 3.0 + 0.1 * i
            c2w[0, 3] = 0.05 * (i % 7)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        return frames

    for split, n in (("train", 100), ("test", 16)):
        with open(d / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": make_frames(split, n)}, f)
    names = [f"r_{i}" for i in [2, 16, 26, 55, 73, 76, 86, 93]]
    md = {a: {b: rng.uniform(0.1, 0.9, (20, 2)).astype(np.float32) for b in names if b != a}
          for a in names}
    np.save(d / "match_data.npy", md, allow_pickle=True)

    # the port's reader writes the random points3d.ply; JAX's reads it back
    np.random.seed(5)
    t = treaders.read_blender_scene(str(d), white_background=True, eval=True)
    j = jreaders.read_blender_scene(str(d), white_background=True, eval=True)
    assert [c.image_name for c in t.train_cameras] == names
    assert len(t.test_cameras) == 16
    assert not t.train_cameras[0].blendermask[:10].any()
    assert (np.array(t.train_cameras[0].image)[:10] > 250).all()
    assert_scene_infos_equal(t, j)
    assert tscene.select_scene_reader(str(d)) == jscene.select_scene_reader(str(d)) == "Blender"

    tb, tnames = tscene.build_bundle_from_scene(t, device="cpu")
    jb, jnames = jscene.build_bundle_from_scene(j)
    assert tnames == jnames == names
    assert_bundles_close(tb, jb)
    assert float(tb.mask.min()) < 1.0  # the masks were warped, not all ones
    tcams = tcu.camera_list_from_infos(t.train_cameras[:2], 2, device="cpu")
    jcams = jcu.camera_list_from_infos(j.train_cameras[:2], 2)
    assert_loaded_cameras_equal(tcams, jcams)


def test_dtu_reader_masks_and_dispatch_match_jax(tmp_path):
    """DTU: 49 views, fixed train indices [25, 22, 28], idr masks (resized
    with the cameras), the dtu path dispatch and the is_dtu flag."""
    d = tmp_path / "dtu_scan1"
    t_generate_scene(str(d), n_views=49, n_gaussians=10, n_points=40, width=32, height=24,
                     name_fmt="rect_{:03d}", device="cpu")
    (d / "idrmask").mkdir()
    rng = np.random.default_rng(0)
    for i in range(49):
        m = np.zeros((24, 32, 3), np.uint8)
        m[4 + i % 3:20, 6:28 - i % 5] = 255
        Image.fromarray(m).save(d / "idrmask" / f"{i:03d}.png")
    all_sorted = sorted(f"rect_{i:03d}" for i in range(49))
    names = sorted(all_sorted[i] for i in (25, 22, 28))
    md = {a: {b: rng.uniform(0.1, 0.9, (15, 2)).astype(np.float32) for b in names if b != a}
          for a in names}
    np.save(d / "match_data.npy", md, allow_pickle=True)

    t = treaders.read_dtu_scene(str(d), "images", eval=True)
    j = jreaders.read_dtu_scene(str(d), "images", eval=True)
    assert {c.image_name for c in t.train_cameras} == set(names)
    assert t.train_cameras[0].dtumask.shape == (24, 32)
    assert_scene_infos_equal(t, j)

    kw = dict(source_path=str(d), resolution=2, eval=True, seed=1)
    ts = tscene.Scene(model_path=str(tmp_path / "t"), device="cpu", **kw)
    js = jscene.Scene(model_path=str(tmp_path / "j"), **kw)
    assert ts.kind == js.kind == "DTU" and ts.is_dtu
    assert ts.train_cameras[0].dtumask.shape == (12, 16)  # cv2's bilinear resize
    assert_loaded_cameras_equal(ts.train_cameras, js.train_cameras)
    assert_loaded_cameras_equal(ts.test_cameras, js.test_cameras)
    assert_bundles_close(ts.bundle, js.bundle)


def test_load_cam_clamps_wide_images_and_warns_once(monkeypatch, capsys):
    rng = np.random.default_rng(4)
    image = Image.fromarray(rng.integers(0, 255, (20, 1700, 3)).astype(np.uint8))
    info = treaders.CameraInfo(uid=3, R=np.eye(3), T=np.array([0.0, 0.1, 0.2]), fovy=0.5,
                               fovx=0.9, image=image, image_path=None, image_name="wide",
                               width=1700, height=20,
                               blendermask=(rng.uniform(size=(20, 1700)) > 0.5))
    monkeypatch.setattr(tcu, "_WARNED", False)
    monkeypatch.setattr(jcu, "_WARNED", True)  # only the port's warning is counted
    first = tcu.load_cam(-1, 0, info, device="cpu")
    second = tcu.load_cam(-1, 1, info, device="cpu")
    assert capsys.readouterr().out.count("rescaling to 1.6K") == 1
    assert (first.width, first.height) == (1600, 18)
    assert_loaded_cameras_equal([first, second],
                                [jcu.load_cam(-1, 0, info), jcu.load_cam(-1, 1, info)])
    for res in (800, 4):
        assert_loaded_cameras_equal([tcu.load_cam(res, 0, info, device="cpu")],
                                    [jcu.load_cam(res, 0, info)])


# ---------------- the synthetic generator ----------------

def test_generate_scene_matches_jax(jax_scene, tmp_path):
    d = tmp_path / "port_scene"
    t_out = t_generate_scene(str(d), device="cpu", **SCENE)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (d / "sparse/0" / name).read_bytes() == (
            open(os.path.join(jax_scene, "sparse/0", name), "rb").read()), name
    assert (d / "match_data.npy").read_bytes() == (
        open(os.path.join(jax_scene, "match_data.npy"), "rb").read())
    names = sorted(os.listdir(os.path.join(jax_scene, "images")))
    assert sorted(os.listdir(d / "images")) == names == [f"img_{v:03d}.png" for v in range(10)]
    worst = 0
    for name in names:
        a = np.asarray(Image.open(d / "images" / name)).astype(np.int32)
        b = np.asarray(Image.open(os.path.join(jax_scene, "images", name))).astype(np.int32)
        assert a.shape == b.shape == (48, 64, 3)
        worst = max(worst, int(np.abs(a - b).max()))
    assert worst <= 1
    assert [n + ".png" for n in t_out["names"]] == names and len(t_out["Rs"]) == 10
    assert t_out["centers"].shape == (40, 3)


def test_generate_scene_resolves_the_gpu_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_generate_scene(str(tmp_path / "s"), **SCENE)


# ---------------- poses, spirals, video scenes ----------------

def test_pose_utils_spirals_and_video_scenes_match_jax(jax_scene, tmp_path):
    port_dir, jax_dir = tmp_path / "p", tmp_path / "j"
    shutil.copytree(jax_scene, port_dir)
    shutil.copytree(jax_scene, jax_dir)
    tpose.gen_poses(str(port_dir))
    jpose.gen_poses(str(jax_dir))
    assert (port_dir / "poses_bounds.npy").read_bytes() == (
        jax_dir / "poses_bounds.npy").read_bytes()
    assert_scene_infos_equal(treaders.create_llff_spiral(str(port_dir)),
                             jreaders.create_llff_spiral(str(jax_dir)))
    assert_scene_infos_equal(treaders.create_tanks_spiral(str(port_dir)),
                             jreaders.create_tanks_spiral(str(jax_dir)))
    tv = tscene.VideoScene(str(port_dir), str(tmp_path / "tm"), resolution=4,
                           load_iteration=None, device="cpu")
    jv = jscene.VideoScene(str(jax_dir), str(tmp_path / "jm"), resolution=4, load_iteration=None)
    assert tv.cameras_extent == jv.cameras_extent and len(tv.test_cameras) == 180
    assert_loaded_cameras_equal(tv.test_cameras[::45], jv.test_cameras[::45])

    rng = np.random.default_rng(7)
    poses = np.stack([np.concatenate([jcolmap.qvec2rotmat(q / np.linalg.norm(q)),
                                      rng.normal(size=(3, 1))], 1)
                      for q in rng.normal(size=(6, 4))])
    assert_equal(tpose.generate_spiral_path_dtu(poses, n_frames=16),
                 jpose.generate_spiral_path_dtu(poses, n_frames=16))
    assert_equal(tpose.generate_spiral_path(poses, np.array([[1.0, 5.0]]), n_frames=16),
                 jpose.generate_spiral_path(poses, np.array([[1.0, 5.0]]), n_frames=16))
    c2w = np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]], (6, 1, 1))], 1)
    assert_equal(tvp.interpolate_virtual_poses_sequential(c2w, 7),
                 jvp.interpolate_virtual_poses_sequential(c2w, 7))
    np.random.seed(9)
    want = jvp.get_near_virtual_pose(c2w, [1.0, 4.0])
    np.random.seed(9)
    assert_equal(tvp.get_near_virtual_pose(c2w, [1.0, 4.0]), want)
