"""A name-by-name comparison of the two packages, read from their files
(nothing is imported).

For every module ``tsdf_tpu/<path>.py``, each public name it defines at
the top level (a function, a class, an alias such as ``compute_normals =
compute_normals_from_vertices``) and each public method of its classes
must be defined in ``tsdf_tpu_torch/<path>.py`` too, unless it is written
below as TPU plumbing that gets no port (ROADMAP.md Queue 2). What is
missing must be exactly that list: every other name is ported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "tsdf_tpu"
PORT = ROOT / "tsdf_tpu_torch"

# module -> names missing from the port, by reason
NO_PORT = "no port: TPU plumbing (ROADMAP Queue 2)"

REMAINING = {
    "struct.py": (NO_PORT, {"field", "pytree_dataclass"}),
    "ops/scatter.py": (NO_PORT, {
        "gather_flat", "scatter_add_flat", "scatter_set_int", "take_flat",
    }),
    "pipelines/scenefusion.py": (NO_PORT, {"update_deformation_cubes"}),
    "kernels/bilateral.py": (NO_PORT, {"bilateral_filter_pallas"}),
    "kernels/gather.py": (NO_PORT, {
        "lane_gather", "lane_gather_any", "mxu_transpose", "row_gather_any",
    }),
    "kernels/integrate.py": (NO_PORT, {
        "integrate_auto", "integrate_color_pallas", "integrate_pallas",
        "integrate_warped_pallas", "warped_miss_topup",
    }),
    "kernels/raycast.py": (NO_PORT, {"raycast_pallas"}),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def public_names(path: pathlib.Path) -> set[str]:
    """Public top-level functions, classes and aliases of a module, and
    the public methods of its classes as ``Class.method``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{item.name}" for item in node.body
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and _public(item.name))
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name) and _public(t.id))
    return names


def missing_names() -> dict[str, set[str]]:
    out = {}
    for path in sorted(JAX.rglob("*.py")):
        rel = path.relative_to(JAX).as_posix()
        counterpart = PORT / rel
        have = public_names(counterpart) if counterpart.exists() else set()
        missing = public_names(path) - have
        if missing:
            out[rel] = missing
    return out


def test_what_remains_to_port_is_exactly_the_written_list():
    assert missing_names() == {m: names for m, (_, names) in REMAINING.items()}


@pytest.mark.parametrize("module", [
    "camera.py", "cli.py", "io/block_tsdf.py", "io/convert.py",
    "io/depth_image.py", "io/file_utils.py", "io/pgm.py", "io/tum.py",
    "native/__init__.py", "ops/shading.py", "tracking/icp.py", "utils/checkpoint.py",
    "utils/profiling.py", "parallel/distributed.py", "parallel/halo.py",
    "parallel/mesh.py", "parallel/ops.py", "volume.py",
])
def test_module_has_every_jax_name(module):
    """The modules this comparison found short, each complete now."""
    assert (PORT / module).exists()
    assert public_names(JAX / module) <= public_names(PORT / module)


def test_the_walk_sees_methods_aliases_and_classes():
    names = public_names(JAX / "ops" / "shading.py")
    assert {"compute_normals", "scene_image", "normals_image"} <= names
    assert {"Camera", "Camera.world_to_pixel", "Camera.position"} <= public_names(
        JAX / "camera.py")
    assert "TSDFVolume._replace" not in public_names(JAX / "volume.py")
