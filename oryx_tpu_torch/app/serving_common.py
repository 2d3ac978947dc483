"""Shared serving-resource helpers for all apps.

Rebuild of AbstractOryxResource (app/oryx-app-serving/.../serving/
AbstractOryxResource.java:54-182): the model-readiness gate against
oryx.serving.min-model-load-fraction (503 until loaded), input-topic
send helper, read-only guard, and compressed/multipart ingest body
decoding (Ingest accepts raw text, gzip, zip, and multipart forms).

Port note: a copy of ``oryx_tpu/app/serving_common.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import gzip
import io
import zipfile

from oryx_tpu_torch.serving.web import OryxServingException, Request, ServingContext


def get_ready_model(ctx: ServingContext):
    """The serving model, or 503 while insufficiently loaded
    (AbstractOryxResource.getServingModel:75-97)."""
    manager = ctx.model_manager
    model = manager.get_model() if manager is not None else None
    if model is not None:
        min_fraction = ctx.config.get_float("oryx.serving.min-model-load-fraction")
        if model.get_fraction_loaded() >= min_fraction:
            return model
    raise OryxServingException(503, "model not available yet")


def check_not_read_only(ctx: ServingContext) -> None:
    if ctx.model_manager is not None and ctx.model_manager.is_read_only():
        raise OryxServingException(403, "read-only instance")


def send_input(ctx: ServingContext, line: str) -> None:
    """Write one event line to the input topic
    (AbstractOryxResource.sendInput:65-69; keyed by line hash)."""
    if ctx.input_producer is None:
        raise OryxServingException(503, "no input topic configured")
    ctx.input_producer.send(format(abs(hash(line)) & 0xFFFFFFFF, "x"), line)


def read_ingest_lines(req: Request) -> list[str]:
    """Decode an ingest body: plain text, gzip, zip archive, or a
    multipart form of any of those (AbstractOryxResource.java:99-132)."""
    content_type = req.headers.get("Content-Type", "").lower()
    bodies: list[bytes] = []
    if content_type.startswith("multipart/"):
        bodies = _parse_multipart(req)
    else:
        body = req.body
        # Content-Encoding: gzip is already undone by the HTTP layer; this
        # handles a gzip content-TYPE (a .csv.gz file POSTed directly)
        if content_type.endswith("gzip"):
            body = gzip.decompress(body)
        elif content_type.endswith("zip"):
            bodies.extend(_unzip(body))
            body = b""
        if body:
            bodies.append(body)
    lines: list[str] = []
    for b in bodies:
        for line in b.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if line:
                lines.append(line)
    if not lines and not bodies:
        raise OryxServingException(400, "no content")
    return lines


def _unzip(body: bytes) -> list[bytes]:
    out = []
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        for name in zf.namelist():
            out.append(zf.read(name))
    return out


def _parse_multipart(req: Request) -> list[bytes]:
    import email
    import email.policy

    content_type = req.headers.get("Content-Type", "")
    msg = email.message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + req.body,
        policy=email.policy.HTTP,
    )
    out: list[bytes] = []
    for part in msg.iter_parts():
        payload = part.get_payload(decode=True)
        if payload is None:
            continue
        filename = (part.get_filename() or "").lower()
        ctype = (part.get_content_type() or "").lower()
        if filename.endswith(".gz") or "gzip" in ctype:
            payload = gzip.decompress(payload)
            out.append(payload)
        elif filename.endswith(".zip") or "zip" in ctype:
            out.extend(_unzip(payload))
        else:
            out.append(payload)
    if not out:
        raise OryxServingException(400, "no multipart content")
    return out
