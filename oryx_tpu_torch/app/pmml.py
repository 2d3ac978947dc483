"""App-tier PMML glue.

Rebuild of AppPMMLUtils (app/oryx-app-common/.../pmml/AppPMMLUtils.java:
59-285): PMML Extension get/set (the ALS model's pointers live in
extensions), DataDictionary/MiningSchema construction from an InputSchema,
and resolution of update-topic model messages — "MODEL" carries inline
PMML, "MODEL-REF" carries a path to read it from
(readPMMLFromUpdateKeyMessage, AppPMMLUtils.java:256-285).

Port note: a copy of ``oryx_tpu/app/pmml.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``. MODEL-REF resolves without the restage
cache, which the port has not taken over yet.
"""

from __future__ import annotations

import logging
from pathlib import Path
from xml.etree.ElementTree import Element

from oryx_tpu_torch.common import pmml as pmml_io, storage
from oryx_tpu_torch.app.schema import CategoricalValueEncodings, InputSchema

log = logging.getLogger(__name__)

# file name of the PMML document inside a published generation dir
MODEL_FILE_NAME = "model.pmml"


# -- extensions -------------------------------------------------------------


def add_extension(root: Element, name: str, value) -> None:
    pmml_io.sub(root, "Extension", {"name": name, "value": str(value)})


def add_extension_content(root: Element, name: str, content: list) -> None:
    """Extension whose content is a space-joined token list
    (AppPMMLUtils.addExtensionContent). Tokens with spaces are quoted."""
    if not content:
        return
    from oryx_tpu_torch.common.text import join_delimited

    e = pmml_io.sub(root, "Extension", {"name": name})
    e.text = join_delimited([str(x) for x in content], " ")


def get_extension_value(root: Element, name: str) -> str | None:
    for ext in pmml_io.findall(root, "Extension"):
        if ext.get("name") == name:
            return ext.get("value")
    return None


def get_extension_content(root: Element, name: str) -> list[str] | None:
    from oryx_tpu_torch.common.text import parse_delimited

    for ext in pmml_io.findall(root, "Extension"):
        if ext.get("name") == name and ext.get("value") is None:
            return parse_delimited(ext.text or "", " ")
    return None


def get_required_extension_value(root: Element, name: str) -> str:
    v = get_extension_value(root, name)
    if v is None:
        raise ValueError(f"missing PMML extension {name}")
    return v


# -- schema -> PMML ---------------------------------------------------------


def build_data_dictionary(
    root: Element, schema: InputSchema, encodings: CategoricalValueEncodings | None = None
) -> Element:
    """DataDictionary from schema (AppPMMLUtils.buildDataDictionary:195-227).

    Mirrors the reference's field set exactly: EVERY feature gets a
    DataField — id/ignored features as bare fields with no optype or
    dataType — and numberOfFields counts them all, so a document written
    here is column-for-column what the reference's JAXB writer emits."""
    dd = pmml_io.sub(root, "DataDictionary")
    for i, name in enumerate(schema.feature_names):
        if schema.is_numeric(i):
            pmml_io.sub(dd, "DataField", {"name": name, "optype": "continuous", "dataType": "double"})
        elif schema.is_categorical(i):
            df = pmml_io.sub(dd, "DataField", {"name": name, "optype": "categorical", "dataType": "string"})
            if encodings is not None:
                for v, _ in sorted(
                    encodings.value_to_index_map(i).items(), key=lambda kv: kv[1]
                ):
                    pmml_io.sub(df, "Value", {"value": v})
        else:
            pmml_io.sub(dd, "DataField", {"name": name})
    dd.set("numberOfFields", str(len(schema.feature_names)))
    return dd


def build_mining_schema(
    parent: Element, schema: InputSchema, importances: list[float] | None = None
) -> Element:
    """MiningSchema mirroring AppPMMLUtils.buildMiningSchema:140-171:
    every feature appears; numeric/categorical actives carry optype +
    usageType=active, id/ignored features usageType=supplementary (no
    optype), the target's usageType is overridden to predicted, and
    importances land on active predictor fields."""
    ms = pmml_io.sub(parent, "MiningSchema")
    for i, name in enumerate(schema.feature_names):
        attrs = {"name": name}
        if schema.is_numeric(i):
            attrs["optype"] = "continuous"
            attrs["usageType"] = "active"
        elif schema.is_categorical(i):
            attrs["optype"] = "categorical"
            attrs["usageType"] = "active"
        else:
            attrs["usageType"] = "supplementary"
        if schema.is_target(i):
            attrs["usageType"] = "predicted"
        if attrs["usageType"] == "active" and importances is not None:
            p = schema.feature_to_predictor_index(i)
            attrs["importance"] = repr(float(importances[p]))
        pmml_io.sub(ms, "MiningField", attrs)
    return ms


def build_categorical_encodings(pmml_root: Element, schema: InputSchema) -> CategoricalValueEncodings:
    """Recover encodings from DataDictionary Values
    (AppPMMLUtils.buildCategoricalValueEncodings:208-229)."""
    distinct: dict[int, list[str]] = {}
    dd = pmml_io.find(pmml_root, "DataDictionary")
    if dd is not None:
        for df in pmml_io.findall(dd, "DataField"):
            values = [v.get("value") for v in pmml_io.findall(df, "Value")]
            if values:
                feat = schema.feature_names.index(df.get("name"))
                distinct[feat] = values
    return CategoricalValueEncodings(distinct)


# -- update-topic model resolution ------------------------------------------


def read_pmml_from_update_message(key: str, message: str) -> Element | None:
    """Resolve a MODEL / MODEL-REF update message to a PMML tree, or None
    for other keys (AppPMMLUtils.readPMMLFromUpdateKeyMessage:256-285).
    A MODEL-REF whose path has vanished returns None (logged by caller)."""
    if key == "MODEL":
        return pmml_io.from_string(message)
    if key == "MODEL-REF":
        # the path may be local or an object-store URI (gs://...) — the
        # reference reads referenced models from HDFS the same way. The
        # registry publishes refs as *generation dirs* (resolvable to
        # manifest + artifacts, not just the document), so try
        # <ref>/model.pmml first; a plain file path (legacy producers)
        # still resolves. A poison reference (unknown scheme, missing
        # storage backend, vanished path) must never kill a consumer loop:
        # resolve to None.
        try:
            ref = message
            in_dir = storage.join(ref, MODEL_FILE_NAME)
            if storage.exists(in_dir):
                return pmml_io.from_string(storage.read_text(in_dir))
            if not storage.exists(ref):
                return None
            return pmml_io.from_string(storage.read_text(ref))
        except Exception:
            log.warning("unresolvable MODEL-REF %r", message, exc_info=True)
            return None
    return None

