"""Minimal URDF -> `SerialChain` ingestion (pure Python, no Pinocchio).

JAX-side replacement for the reference's URDF pipeline
(`/root/reference/biped_pympc/casadi/t1_kinematics.py:24-54`: Pinocchio
parses `model/t1_serial.urdf`, locks the non-leg joints, and exports CasADi
FK/Jacobian functions per foot). Here the same information — per-joint
origin translations and rotation axes along the root->tip path — is read
directly from the URDF XML and packed into a `models.chain.SerialChain`,
which `models/chain.py` evaluates batched in JAX.

Scope (deliberately the class of chains the MPC stack uses):
  * every joint on the path must be `revolute`/`continuous` about a
    positive principal axis (+x/+y/+z), or `fixed`, or listed in `locked`
    (treated as fixed at q = 0);
  * all origins on the path must have rpy == 0 (pure translations) — true
    of the T1 legs; a chain outside this class raises with a clear message
    rather than silently mis-modeling.

Fixed/locked translations are folded into the neighbouring moving joint's
offset (exact when rpy == 0 and the locked angle is 0, which is how the
reference locks the waist — `t1_kinematics.py:28-37` reduced model at
q_ref = 0); a trailing fixed transform (the foot sole) becomes the tip
offset, and any prefix before the first moving joint becomes base_offset.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from biped_pympc_tpu.models.chain import SerialChain

_AXES = {
    (1.0, 0.0, 0.0): "x",
    (0.0, 1.0, 0.0): "y",
    (0.0, 0.0, 1.0): "z",
}

# Vendored kinematics-only T1 model (derived projection of the reference's
# in-repo asset `model/t1_serial.urdf`; regenerate with
# `tools/derive_urdf_fixture.py`). Lets a standalone checkout run the
# parser and regenerate the T1 chain constants without the reference tree.
import os as _os

T1_FIXTURE_URDF = _os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "assets",
    "t1_kinematics.urdf",
)


def _vec3(s: str | None) -> np.ndarray:
    if not s:
        return np.zeros(3)
    return np.array([float(v) for v in s.split()])


def chain_from_urdf(
    urdf_path: str,
    root_link: str,
    tip_link: str,
    locked: tuple[str, ...] = (),
) -> SerialChain:
    """Extract the serial chain from `root_link` to `tip_link`.

    locked: joint names to treat as fixed at q = 0 (the reference's
    reduced-model lock, `t1_kinematics.py:28-37`).
    """
    root = ET.parse(urdf_path).getroot()
    by_child: dict[str, ET.Element] = {}
    for j in root.findall("joint"):
        by_child[j.find("child").get("link")] = j

    # Walk tip -> root through the parent pointers, then reverse.
    path: list[ET.Element] = []
    link = tip_link
    while link != root_link:
        j = by_child.get(link)
        if j is None:
            raise ValueError(
                f"no joint chain from '{root_link}' to '{tip_link}' "
                f"(dead end at link '{link}')"
            )
        path.append(j)
        link = j.find("parent").get("link")
    path.reverse()

    base_offset = None  # fixed prefix before the first moving joint
    pending = np.zeros(3)  # accumulated fixed/locked translation
    offsets: list[np.ndarray] = []
    axes = ""
    for j in path:
        name = j.get("name")
        origin = j.find("origin")
        xyz = _vec3(origin.get("xyz") if origin is not None else None)
        rpy = _vec3(origin.get("rpy") if origin is not None else None)
        if np.any(rpy != 0.0):
            raise ValueError(
                f"joint '{name}' has rpy={rpy.tolist()}; only pure-"
                "translation origins are supported by SerialChain"
            )
        jtype = j.get("type")
        if jtype == "fixed" or name in locked:
            pending = pending + xyz
            continue
        if jtype not in ("revolute", "continuous"):
            raise ValueError(f"unsupported joint type '{jtype}' at '{name}'")
        axis = tuple(_vec3(j.find("axis").get("xyz")))
        if axis not in _AXES:
            raise ValueError(
                f"joint '{name}' axis {list(axis)} is not a positive "
                "principal axis (+x/+y/+z)"
            )
        if base_offset is None:
            base_offset = pending
            offsets.append(xyz)
        else:
            offsets.append(pending + xyz)
        pending = np.zeros(3)
        axes += _AXES[axis]

    if not axes:
        raise ValueError(
            f"no movable joints between '{root_link}' and '{tip_link}'"
        )
    return SerialChain(
        base_offset=base_offset,
        joint_offsets=np.array(offsets),
        axes=axes,
        tip_offset=pending,  # trailing fixed transform (e.g. foot sole)
    )
