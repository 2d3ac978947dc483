"""PMML 4.2-compatible model artifact read/write.

Rebuild of the reference's PMMLUtils (framework/oryx-common/src/main/java/
com/cloudera/oryx/common/pmml/PMMLUtils.java:41-140): build a skeleton PMML
document, read/write files, and round-trip to a string — PMML is the model
interchange format flowing over the update topic as "MODEL" messages or
referenced from "MODEL-REF" paths. Implemented on xml.etree (no external
JAXB-equivalent needed); app-level helpers for extensions, mining schemas,
and model-type-specific content live in oryx_tpu_torch.app.pmml.

Port note: a copy of ``oryx_tpu/common/pmml.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

PMML_NAMESPACE = "http://www.dmg.org/PMML-4_2"
PMML_VERSION = "4.2.1"

ET.register_namespace("", PMML_NAMESPACE)

__all__ = [
    "PMML_NAMESPACE",
    "PMML_VERSION",
    "q",
    "build_skeleton_pmml",
    "read_pmml",
    "write_pmml",
    "to_string",
    "from_string",
    "sub",
    "find",
    "findall",
]


def q(tag: str) -> str:
    """Qualified tag name in the PMML namespace."""
    return f"{{{PMML_NAMESPACE}}}{tag}"


def build_skeleton_pmml(app_name: str = "oryx_tpu_torch") -> ET.Element:
    """New PMML root with Header/Application/Timestamp.

    Mirrors PMMLUtils.buildSkeletonPMML (PMMLUtils.java:50-66).
    """
    import datetime

    root = ET.Element(q("PMML"), {"version": PMML_VERSION})
    header = ET.SubElement(root, q("Header"))
    from oryx_tpu_torch import __version__

    ET.SubElement(header, q("Application"), {"name": app_name, "version": __version__})
    ts = ET.SubElement(header, q("Timestamp"))
    ts.text = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    return root


def sub(parent: ET.Element, tag: str, attrib: dict | None = None, text: str | None = None) -> ET.Element:
    e = ET.SubElement(parent, q(tag), attrib or {})
    if text is not None:
        e.text = text
    return e


def find(root: ET.Element, path: str) -> ET.Element | None:
    """Find by slash-separated local tag names (namespace applied)."""
    return root.find("/".join(q(p) for p in path.split("/")))


def findall(root: ET.Element, path: str) -> list[ET.Element]:
    return root.findall("/".join(q(p) for p in path.split("/")))


def local_name(elem: ET.Element) -> str:
    tag = elem.tag
    return tag.rsplit("}", 1)[-1] if "}" in tag else tag


def to_string(root: ET.Element) -> str:
    return ET.tostring(root, encoding="unicode")


def from_string(text: str) -> ET.Element:
    return ET.fromstring(text)


def write_pmml(root: ET.Element, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    ET.ElementTree(root).write(str(path), encoding="utf-8", xml_declaration=True)


def read_pmml(path: str | Path) -> ET.Element:
    return ET.parse(str(path)).getroot()
