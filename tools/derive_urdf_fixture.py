"""Derive the vendored kinematic URDF fixture from the reference asset.

The reference ships the full Booster T1 model in-repo
(`/root/reference/model/t1_serial.urdf`, 1308 lines: meshes, inertials,
collision geometry, limits). The only content this framework consumes is
the KINEMATIC TREE — joint connectivity, origins, axes and types
(`biped_pympc_tpu/models/urdf.py`) — so the vendored fixture
(`biped_pympc_tpu/models/assets/t1_kinematics.urdf`) is a derived,
kinematics-only projection: every <link> reduced to its name, every
<joint> reduced to {type, parent, child, origin, axis}. That keeps the
standalone repo able to regenerate the T1 chain constants and run the
parser tests without copying
the asset wholesale.

Regenerate (only when the reference model changes):
    python tools/derive_urdf_fixture.py \
        [--src /root/reference/model/t1_serial.urdf] [--dst <fixture>]
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

DEFAULT_SRC = "/root/reference/model/t1_serial.urdf"
DEFAULT_DST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "biped_pympc_tpu", "models", "assets", "t1_kinematics.urdf",
)


def derive(src: str, dst: str) -> None:
    root = ET.parse(src).getroot()
    out = ET.Element("robot", {"name": root.get("name", "t1_kinematics")})
    out.append(ET.Comment(
        " KINEMATICS-ONLY fixture derived from the reference asset "
        "model/t1_serial.urdf by tools/derive_urdf_fixture.py. "
        "Links are name-only; joints keep type/parent/child/origin/axis. "
        "Inertials, meshes, collision geometry and limits are intentionally "
        "absent - the MPC stack consumes only the kinematic tree. "
    ))
    for link in root.findall("link"):
        ET.SubElement(out, "link", {"name": link.get("name")})
    for joint in root.findall("joint"):
        j = ET.SubElement(out, "joint", {
            "name": joint.get("name"), "type": joint.get("type"),
        })
        for tag in ("parent", "child", "origin", "axis"):
            el = joint.find(tag)
            if el is not None:
                ET.SubElement(j, tag, dict(el.attrib))
    tree = ET.ElementTree(out)
    ET.indent(tree, space="  ")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tree.write(dst, encoding="unicode")
    with open(dst, "a") as f:
        f.write("\n")
    print(f"wrote {dst} ({os.path.getsize(dst)} bytes) from {src}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=DEFAULT_SRC)
    ap.add_argument("--dst", default=DEFAULT_DST)
    args = ap.parse_args()
    derive(args.src, args.dst)
