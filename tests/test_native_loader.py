"""Native (C++) OBJ loader parity with the Python parser, on OBJ files
written from the generated ~5k-face figure and a quad-faced box."""
import time

import numpy as np
import pytest

from tpu_renderer.models import gizmos, native
from tpu_renderer.models.model import Model
from tpu_renderer.utils.objwrite import write_obj, write_textured_box


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.native_available():
        pytest.skip("no C++ toolchain available")


@pytest.fixture(scope="module")
def obj_files(tmp_path_factory):
    """{"figure": path, "box": path}: the figure with per-corner uv and
    vertex normals (v/vt/vn triples), and a box of six quads."""
    root = tmp_path_factory.mktemp("objs")
    fig = gizmos.make_noise_figure(seed=0)
    fa = fig.face_array
    faces = [[tuple(int(i) for i in corner[:3]) for corner in face]
             for face in fa]
    figure = write_obj(str(root / "figure.obj"), fig.vertices[:, :3],
                       fig.uv[:, :2], fig.normals, faces)
    box = write_textured_box(str(root / "box.obj"), None)
    return {"figure": figure, "box": box}


@pytest.mark.parametrize("name", ["figure", "box"])
def test_native_matches_python(obj_files, name):
    path = obj_files[name]
    py = Model.load_model(path, use_native=False)
    nat = Model.load_model(path, use_native=True)
    np.testing.assert_array_equal(nat.vertices, py.vertices)
    np.testing.assert_array_equal(nat.face_array, py.face_array)
    if py.uv is None:
        assert nat.uv is None
    else:
        np.testing.assert_array_equal(nat.uv, py.uv)
    if py.normals is None:
        assert nat.normals is None
    else:
        np.testing.assert_array_equal(nat.normals, py.normals)
    assert nat.material_group == py.material_group
    assert set(nat.materials) == set(py.materials)


def test_native_is_faster(obj_files):
    path = obj_files["figure"]
    t = time.perf_counter()
    for _ in range(3):
        Model.load_model(path, use_native=False)
    py_dt = (time.perf_counter() - t) / 3
    t = time.perf_counter()
    for _ in range(3):
        Model.load_model(path, use_native=True)
    nat_dt = (time.perf_counter() - t) / 3
    assert nat_dt < py_dt, (nat_dt, py_dt)


def test_negative_and_missing_indices(tmp_path):
    obj = tmp_path / "t.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4//1\n"      # quad -> fan, one corner missing vt
        "f -1 -2 -3\n")                     # relative indices, bare corners
    py = Model.load_model(str(obj), use_native=False)
    nat = Model.load_model(str(obj), use_native=True)
    np.testing.assert_array_equal(nat.face_array, py.face_array)
    np.testing.assert_array_equal(nat.vertices, py.vertices)
    assert py.face_array.shape[0] == 3  # 2 fan triangles + 1
