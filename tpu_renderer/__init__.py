"""tpu_renderer: a 3D software rendering engine in JAX/XLA.

Public API mirrors the reference NumPy renderer (Denizantip/py-numpy-renderer):

    from tpu_renderer import Model, Camera, Light, Scene, CubeMap, Lightning
    from tpu_renderer import scale, translation, rotate, rotate_xyz
    from tpu_renderer import SYSTEM, SUBSYSTEM, PROJECTION_TYPE

    model = Model.load_model("diablo3_pose.obj")
    model.textures.register("diffuse", "diablo3_pose_diffuse.tga", normalize=False)
    model = model @ scale(1.0) @ translation([0, 0, 0]) @ rotate_xyz([0, 15, 0])
    scene = Scene(Camera((0.5, 3, 5), center=(0, 0, 0)), Light((5, 5, 0)),
                  resolution=(1024, 1024), system=SYSTEM.LH,
                  subsystem=SUBSYSTEM.OPENGL, shadows=True)
    scene.add_model(model)
    frame = scene.render()          # (H, W, 3) uint8

Importing the package sets the XLA flags under which renders round the same
on every device (:mod:`tpu_renderer.precision`): import it before running
anything on JAX.
"""
import sys as _sys

from tpu_renderer import precision as _precision

_precision.use_exact_f32_math()

from tpu_renderer.constants import PROJECTION_TYPE, SUBSYSTEM, SYSTEM
from tpu_renderer.models.camera import Camera, Light
from tpu_renderer.models.face import Face
from tpu_renderer.models.model import Model
from tpu_renderer.models.scene import Scene
from tpu_renderer.ops.cubemap import CubeMap
from tpu_renderer.ops.errors import Errors
from tpu_renderer.ops.lightning import Lightning
from tpu_renderer.ops.pipeline import (SHADER_FLAT, SHADER_GENERAL,
                                       SHADER_GOURAUD, SHADER_PBR,
                                       SHADER_POINTS, SHADER_WIREFRAME)
from tpu_renderer.ops.transforms import (rotate, rotate_xyz, scale,
                                         translation)

# Reference-style module aliases: the reference is imported as
# ``from transformation import scale`` / ``from obj.lightning import
# Lightning`` (main.py:6-10); mirror those paths under this package.
from tpu_renderer import constants  # noqa: F401
from tpu_renderer.ops import transforms as transformation
from tpu_renderer.ops import lightning  # noqa: F401
from tpu_renderer.ops import frustum as plane_intersection

_sys.modules[__name__ + ".transformation"] = transformation
_sys.modules[__name__ + ".plane_intersection"] = plane_intersection


def host_build():
    """Context manager: run eager scene-construction math on the host CPU.

    ``tr.scale/rotate/translation`` and ``Model @ matrix`` execute eagerly;
    on an accelerator every such small op is a separate device dispatch.
    Wrap construction in ``with tr.host_build():`` — the arrays transfer to
    the accelerator when the scene is packed. Needs JAX's CPU backend beside
    the accelerator's (the default unless ``JAX_PLATFORMS`` excludes it).
    """
    import jax
    return jax.default_device(jax.devices("cpu")[0])


__all__ = [
    "Model", "Camera", "Light", "Scene", "CubeMap", "Lightning", "Face",
    "Errors", "scale", "translation", "rotate", "rotate_xyz",
    "SYSTEM", "SUBSYSTEM", "PROJECTION_TYPE",
    "SHADER_GENERAL", "SHADER_FLAT", "SHADER_GOURAUD", "SHADER_PBR",
    "SHADER_WIREFRAME", "SHADER_POINTS",
    "transformation", "plane_intersection", "constants", "lightning",
    "host_build",
]

__version__ = "0.1.0"
