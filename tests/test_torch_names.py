"""Name parity: every public name of every module of the JAX package
exists in the port's counterpart module (ra_slam_tpu_torch, same
subpackage and module name), except ROADMAP.md's "Not to port" list.

A module's public names are those it defines, its constants (whatever
their origin, so a constant one module re-exports from another counts),
and, for a package, every name its `__init__` re-exports. For each class
a module defines: its public methods and properties, and a named tuple's
fields. An attribute the port resolves on the instance (`FrameInfo`'s
scalar fields, through `__getattr__`) is looked up on an instance. The
JAX side imports its modules and runs no kernel (`PinholeCamera.matrix`
is a few jnp ops).
"""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import torch

import ra_slam_tpu

# ROADMAP.md, "Not to port": TPU mechanics and their constants
NOT_TO_PORT_MODULES = ("ra_slam_tpu.utils.aot_cache", "ra_slam_tpu.native", "ra_slam_tpu.ops.tsdf_pallas")
NOT_TO_PORT_NAMES = {
    "ra_slam_tpu.ops": {"hamming_matrix_pallas"},
    "ra_slam_tpu.ops.hamming": {"hamming_matrix_pallas", "TILE_A", "TILE_B"},
    "ra_slam_tpu.features.orb": {"FCELL", "FTP", "MARGIN"},
    "ra_slam_tpu.map.hash_table": {"MAX_PROBE"},
    "ra_slam_tpu.map.meshing": {"MAX_TRIS_PER_BLOCK", "DELTA_SENTINEL"},
}


def _frame_info():
    from ra_slam_tpu_torch.slam import system

    zero = torch.zeros(())
    return system.FrameInfo(torch.eye(3), torch.zeros(3), **{k: zero for k in system._INFO_FIELDS})


# classes whose attributes the port resolves on an instance
INSTANCES = {("ra_slam_tpu.slam.system", "FrameInfo"): _frame_info}


def _own(obj) -> bool:
    m = getattr(obj, "__module__", None)
    return isinstance(m, str) and (m == "ra_slam_tpu" or m.startswith("ra_slam_tpu."))


def _public_names(mod) -> dict:
    is_package = hasattr(mod, "__path__")
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if inspect.isclass(obj) or callable(obj):
            if _own(obj) and (is_package or obj.__module__ == mod.__name__):
                out[name] = obj
        elif type(obj).__module__ in ("builtins", "numpy") or _own(type(obj)):
            out[name] = obj
    return out


def _members(cls) -> set:
    names = set()
    for c in cls.__mro__:
        if not _own(c):
            continue
        for name, v in vars(c).items():
            if name.startswith("_"):
                continue
            if inspect.isfunction(v) or isinstance(v, (staticmethod, classmethod, property)) \
                    or name in getattr(c, "_fields", ()):
                names.add(name)
    return names


def _has_member(cls, name: str) -> bool:
    """An attribute of the class, or a field it declares (a dataclass
    field without a default is no class attribute)."""
    return hasattr(cls, name) or any(name in getattr(c, "__annotations__", {}) for c in cls.__mro__)


def _jax_modules():
    for info in pkgutil.walk_packages(ra_slam_tpu.__path__, "ra_slam_tpu."):
        if not info.name.startswith(NOT_TO_PORT_MODULES):
            yield info.name


def test_every_public_name_of_the_jax_package_is_ported():
    missing, checked = [], 0
    for name in _jax_modules():
        jmod = importlib.import_module(name)
        try:
            pmod = importlib.import_module(name.replace("ra_slam_tpu", "ra_slam_tpu_torch", 1))
        except ImportError:
            missing.append(f"{name} (module)")
            continue
        skip = NOT_TO_PORT_NAMES.get(name, set())
        for attr, obj in _public_names(jmod).items():
            if attr in skip:
                continue
            checked += 1
            if not hasattr(pmod, attr):
                missing.append(f"{name}.{attr}")
                continue
            if not (inspect.isclass(obj) and obj.__module__ == name):
                continue
            port_cls = getattr(pmod, attr)
            instance = INSTANCES.get((name, attr))
            for member in sorted(_members(obj)):
                checked += 1
                if not _has_member(port_cls, member) and not (instance and hasattr(instance(), member)):
                    missing.append(f"{name}.{attr}.{member}")
    assert not missing, missing
    assert checked > 500  # the walk reached every subpackage


def test_subpackage_exports_import_from_the_port():
    """`from ra_slam_tpu_torch.<sub> import <name>` for every name in a
    JAX subpackage's `__all__`, and the same `__all__`."""
    for name in _jax_modules():
        jmod = importlib.import_module(name)
        if not hasattr(jmod, "__path__") or not hasattr(jmod, "__all__"):
            continue
        port = importlib.import_module(name.replace("ra_slam_tpu", "ra_slam_tpu_torch", 1))
        expect = [n for n in jmod.__all__ if n not in NOT_TO_PORT_NAMES.get(name, set())]
        if name == "ra_slam_tpu.ops":
            assert expect == []
            continue
        assert [n for n in port.__all__ if n in set(expect)] == expect, name
        for n in expect:
            assert getattr(port, n) is not None


def test_camera_matrix_equals_jax():
    from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
    from ra_slam_tpu_torch.core.camera import PinholeCamera

    args = (350.12, 349.87, 335.31, 187.66, 672, 376)
    for scale in (1.0, 0.5):
        ref = np.asarray(JaxCamera.create(*args, scale=scale).matrix())
        k = PinholeCamera.create(*args, scale=scale).matrix("cpu")
        assert k.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_array_equal(k.numpy(), ref)
