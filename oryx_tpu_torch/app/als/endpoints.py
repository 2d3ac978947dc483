"""ALS REST endpoints (counterpart of ``oryx_tpu/app/als/endpoints.py``).

Rebuild of the ~20 JAX-RS resources under app/oryx-app-serving/src/main/
java/com/cloudera/oryx/app/serving/als/ (SURVEY.md §2.10 endpoint table).
Path/query parameter conventions follow the reference: howMany/offset
paging, considerKnownItems, rescorerParams, multi-segment ID lists, and
"item=value" pairs for anonymous endpoints
(e.g. RecommendToAnonymous.java:59, EstimateForAnonymous.java:47-87).
Responses are (id, value) records rendered as JSON objects or text/csv.

Every route of the JAX package's module is here, the HTML console
(``/`` and ``/index.html``, ``serving/console.py``) among them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from oryx_tpu_torch.app.als.common import compute_updated_xu
from oryx_tpu_torch.app.serving_common import (
    check_not_read_only,
    get_ready_model,
    read_ingest_lines,
    send_input,
    send_inputs,
)
from oryx_tpu_torch.common.text import join_csv
from oryx_tpu_torch.common.vectormath import cosine_similarity
from oryx_tpu_torch.serving.web import (
    OryxServingException,
    Request,
    Response,
    ServingContext,
    resource,
)


@dataclass
class IDValue:
    """id/value response record (serving/IDValue.java)."""

    id: str
    value: float

    def to_json(self):
        return {"id": self.id, "value": self.value}

    def to_csv(self) -> str:
        return join_csv([self.id, self.value])


@dataclass
class IDCount:
    id: str
    count: int

    def to_json(self):
        return {"id": self.id, "count": self.count}

    def to_csv(self) -> str:
        return join_csv([self.id, self.count])


def _model(ctx: ServingContext):
    return get_ready_model(ctx)


def _paging(req: Request) -> tuple[int, int]:
    how_many = req.q_int("howMany", 10)
    offset = req.q_int("offset", 0)
    if how_many <= 0 or offset < 0:
        raise OryxServingException(400, "howMany must be positive and offset nonnegative")
    return how_many, offset


def _rescorer(ctx: ServingContext, kind: str, req: Request, ids=()):
    provider = getattr(ctx.model_manager, "rescorer_provider", None)
    if provider is None:
        return None
    args = req.q_list("rescorerParams")
    if kind == "recommend":
        return provider.get_recommend_rescorer(list(ids), args)
    if kind == "anonymous":
        return provider.get_recommend_to_anonymous_rescorer(list(ids), args)
    if kind == "popular":
        return provider.get_most_popular_items_rescorer(args)
    if kind == "active":
        return provider.get_most_active_users_rescorer(args)
    return None


def _parse_item_value_pairs(segments: list[str]) -> list[tuple[str, float]]:
    """["I1=2.0", "I2"] -> [("I1", 2.0), ("I2", 1.0)] (reference anonymous
    endpoints accept itemID or itemID=strength)."""
    out = []
    for seg in segments:
        if "=" in seg:
            item, val = seg.split("=", 1)
            try:
                out.append((item, float(val)))
            except ValueError:
                raise OryxServingException(400, f"bad value in {seg!r}")
        else:
            out.append((seg, 1.0))
    return out


def _anonymous_user_vector(model, pairs: list[tuple[str, float]]) -> np.ndarray:
    """Fold-in temporary user vector from (item, strength) pairs
    (EstimateForAnonymous.buildTemporaryUserVector:73-87)."""
    solver = model.get_yty_solver()
    if solver is None:
        raise OryxServingException(503, "model not yet loaded")
    xu = None
    for item, value in pairs:
        yi = model.get_item_vector(item)
        if yi is None:
            continue
        updated = compute_updated_xu(solver, value, xu, yi, model.implicit)
        if updated is not None:
            xu = updated
    if xu is None:
        raise OryxServingException(400, "no valid items")
    return xu


def _page(results: list, how_many: int, offset: int) -> list:
    return results[offset : offset + how_many]


# -- recommendation ----------------------------------------------------------


@resource("GET", "/recommend/{userID}")
def recommend(ctx: ServingContext, req: Request):
    """als/Recommend.java:68-116."""
    model = _model(ctx)
    user = req.params["userID"]
    # reject unknown users before known-items/rescorer work (providers
    # must not be invoked with ids that don't exist)
    if model.get_user_vector(user) is None:
        raise OryxServingException(404, f"unknown user {user}")
    how_many, offset = _paging(req)
    consider_known = req.q_bool("considerKnownItems", False)
    exclude = set() if consider_known else model.get_known_items(user)
    rescorer = _rescorer(ctx, "recommend", req, [user])
    # top_n_for_user ships an int32 row index when the user is staged on
    # device (index submit)
    results = model.top_n_for_user(
        user, how_many + offset, exclude=exclude, rescorer=rescorer
    )
    if results is None:  # removed between the check and the scan
        raise OryxServingException(404, f"unknown user {user}")
    return [IDValue(i, v) for i, v in _page(results, how_many, offset)]


@resource("GET", "/recommendToMany/{userIDs:+}")
def recommend_to_many(ctx: ServingContext, req: Request):
    """Mean of the users' vectors (als/RecommendToMany.java:57)."""
    model = _model(ctx)
    users = req.params["userIDs"]
    vectors = [model.get_user_vector(u) for u in users]
    vectors = [v for v in vectors if v is not None]
    if not vectors:
        raise OryxServingException(404, "no known users")
    xu = np.mean(vectors, axis=0)
    how_many, offset = _paging(req)
    consider_known = req.q_bool("considerKnownItems", False)
    exclude = set()
    if not consider_known:
        for u in users:
            exclude |= model.get_known_items(u)
    rescorer = _rescorer(ctx, "recommend", req, users)
    results = model.top_n(xu, how_many + offset, exclude=exclude, rescorer=rescorer)
    return [IDValue(i, v) for i, v in _page(results, how_many, offset)]


@resource("GET", "/recommendToAnonymous/{itemValuePairs:+}")
def recommend_to_anonymous(ctx: ServingContext, req: Request):
    """Fold-in vector from item interactions (als/RecommendToAnonymous.java:59)."""
    model = _model(ctx)
    pairs = _parse_item_value_pairs(req.params["itemValuePairs"])
    xu = _anonymous_user_vector(model, pairs)
    how_many, offset = _paging(req)
    exclude = {i for i, _ in pairs}
    rescorer = _rescorer(ctx, "anonymous", req, [i for i, _ in pairs])
    results = model.top_n(xu, how_many + offset, exclude=exclude, rescorer=rescorer)
    return [IDValue(i, v) for i, v in _page(results, how_many, offset)]


@resource("GET", "/recommendWithContext/{userID}/{itemValuePairs:+}")
def recommend_with_context(ctx: ServingContext, req: Request):
    """User vector nudged by recent context items
    (als/RecommendWithContext.java:59)."""
    model = _model(ctx)
    user = req.params["userID"]
    xu = model.get_user_vector(user)
    if xu is None:
        raise OryxServingException(404, f"unknown user {user}")
    pairs = _parse_item_value_pairs(req.params["itemValuePairs"])
    solver = model.get_yty_solver()
    if solver is None:
        raise OryxServingException(503, "model not yet loaded")
    for item, value in pairs:
        yi = model.get_item_vector(item)
        if yi is None:
            continue
        updated = compute_updated_xu(solver, value, xu, yi, model.implicit)
        if updated is not None:
            xu = updated
    how_many, offset = _paging(req)
    exclude = model.get_known_items(user) | {i for i, _ in pairs}
    rescorer = _rescorer(ctx, "recommend", req, [user])
    results = model.top_n(xu, how_many + offset, exclude=exclude, rescorer=rescorer)
    return [IDValue(i, v) for i, v in _page(results, how_many, offset)]


# -- similarity --------------------------------------------------------------


@resource("GET", "/similarity/{itemIDs:+}")
def similarity(ctx: ServingContext, req: Request):
    """Average-cosine similar items (als/Similarity.java:60,
    CosineAverageFunction.java). Scored on device: candidates ranked by
    cosine against the mean of the normalized query vectors."""
    model = _model(ctx)
    items = req.params["itemIDs"]
    vecs = []
    for i in items:
        v = model.get_item_vector(i)
        if v is not None:
            n = np.linalg.norm(v)
            if n > 0:
                vecs.append(v / n)
    if not vecs:
        raise OryxServingException(404, "no known items")
    centroid = np.mean(vecs, axis=0)
    how_many, offset = _paging(req)
    rescorer = _rescorer(ctx, "anonymous", req, items)
    results = model.top_n(
        centroid, how_many + offset + len(items), exclude=set(items),
        rescorer=rescorer, cosine=True,
    )
    scale = float(np.linalg.norm(centroid))  # cos(c, mean) * |mean| = avg cosine
    results = [(i, v * scale) for i, v in results]
    return [IDValue(i, v) for i, v in _page(results, how_many, offset)]


@resource("GET", "/similarityToItem/{toItemID}/{itemIDs:+}")
def similarity_to_item(ctx: ServingContext, req: Request):
    """Cosine similarity of each item to one target (als/SimilarityToItem.java:44)."""
    model = _model(ctx)
    to_vec = model.get_item_vector(req.params["toItemID"])
    if to_vec is None:
        raise OryxServingException(404, "unknown item")
    out = []
    for item in req.params["itemIDs"]:
        v = model.get_item_vector(item)
        out.append(cosine_similarity(v, to_vec) if v is not None else 0.0)
    return out


# -- estimates ---------------------------------------------------------------


@resource("GET", "/estimate/{userID}/{itemIDs:+}")
def estimate(ctx: ServingContext, req: Request):
    """Dot-product estimates (als/Estimate.java:51)."""
    model = _model(ctx)
    xu = model.get_user_vector(req.params["userID"])
    if xu is None:
        raise OryxServingException(404, "unknown user")
    out = []
    for item in req.params["itemIDs"]:
        yi = model.get_item_vector(item)
        out.append(float(np.dot(xu, yi)) if yi is not None else 0.0)
    return out


@resource("GET", "/estimateForAnonymous/{toItemID}/{itemValuePairs:+}")
def estimate_for_anonymous(ctx: ServingContext, req: Request):
    """als/EstimateForAnonymous.java:47-87."""
    model = _model(ctx)
    to_vec = model.get_item_vector(req.params["toItemID"])
    if to_vec is None:
        raise OryxServingException(404, "unknown item")
    pairs = _parse_item_value_pairs(req.params["itemValuePairs"])
    xu = _anonymous_user_vector(model, pairs)
    return float(np.dot(xu, to_vec))


@resource("GET", "/because/{userID}/{itemID}")
def because(ctx: ServingContext, req: Request):
    """Known items most similar to the recommended item — 'why was this
    recommended' (als/Because.java:52)."""
    model = _model(ctx)
    user, item = req.params["userID"], req.params["itemID"]
    yi = model.get_item_vector(item)
    if yi is None:
        raise OryxServingException(404, "unknown item")
    known = model.get_known_items(user)
    if not known:
        raise OryxServingException(404, "no known items for user")
    how_many, offset = _paging(req)
    scored = []
    for k in known:
        v = model.get_item_vector(k)
        if v is not None:
            scored.append(IDValue(k, cosine_similarity(v, yi)))
    scored.sort(key=lambda r: -r.value)
    return _page(scored, how_many, offset)


# -- known items / popularity ------------------------------------------------


@resource("GET", "/knownItems/{userID}")
def known_items(ctx: ServingContext, req: Request):
    """als/KnownItems.java:35."""
    model = _model(ctx)
    return sorted(model.get_known_items(req.params["userID"]))


@resource("GET", "/mostActiveUsers")
def most_active_users(ctx: ServingContext, req: Request):
    """Users by known-item count (als/MostActiveUsers.java:47)."""
    model = _model(ctx)
    how_many, offset = _paging(req)
    rescorer = _rescorer(ctx, "active", req)
    counts = model.get_known_item_counts()
    return _top_counts(counts, how_many, offset, rescorer)


@resource("GET", "/mostPopularItems")
def most_popular_items(ctx: ServingContext, req: Request):
    """Items by how many users know them (als/MostPopularItems.java:52)."""
    model = _model(ctx)
    how_many, offset = _paging(req)
    rescorer = _rescorer(ctx, "popular", req)
    return _top_counts(model.get_item_counts(), how_many, offset, rescorer)


def _top_counts(counts: dict[str, int], how_many, offset, rescorer):
    """Rescorers filter candidates only; counts stay raw counts (the
    reference's mapTopCountsToIDCounts behavior)."""
    entries = [
        IDCount(id_, c)
        for id_, c in counts.items()
        if rescorer is None or not rescorer.is_filtered(id_)
    ]
    entries.sort(key=lambda e: (-e.count, e.id))
    return _page(entries, how_many, offset)


@resource("GET", "/mostSurprising/{userID}")
def most_surprising(ctx: ServingContext, req: Request):
    """Known items with the LOWEST estimated strength — interactions the
    model least expects (als/MostSurprising.java:54)."""
    model = _model(ctx)
    user = req.params["userID"]
    xu = model.get_user_vector(user)
    if xu is None:
        raise OryxServingException(404, "unknown user")
    known = model.get_known_items(user)
    how_many, offset = _paging(req)
    scored = []
    for k in known:
        v = model.get_item_vector(k)
        if v is not None:
            scored.append(IDValue(k, float(np.dot(xu, v))))
    scored.sort(key=lambda r: r.value)
    return _page(scored, how_many, offset)


@resource("GET", "/popularRepresentativeItems")
def popular_representative_items(ctx: ServingContext, req: Request):
    """A small diverse sample of items: the max-dot item along each of
    `features` random hyperplanes (als/PopularRepresentativeItems.java:43
    picks one item per LSH partition; random projections give the same
    'spread across item space' without LSH state)."""
    model = _model(ctx)
    ids, _, uploaded, _y_host, _parts = model._ensure_y_matrix()
    if not ids:
        return []
    from oryx_tpu_torch.common import rng as rng_mod
    from oryx_tpu_torch.ops import topn as topn_ops

    gen = rng_mod.get_random()
    out = []
    seen = set()
    for _ in range(model.features):
        probe = gen.standard_normal(model.features).astype(np.float32)
        idx, _scores = topn_ops.top_k_scores(uploaded, probe, 1)
        id_ = ids[int(idx[0])]
        if id_ not in seen:
            seen.add(id_)
            out.append(id_)
    return out


@resource("GET", "/item/allIDs")
def all_item_ids(ctx: ServingContext, req: Request):
    """als/AllItemIDs.java:34."""
    return sorted(_model(ctx).all_item_ids())


@resource("GET", "/user/allIDs")
def all_user_ids(ctx: ServingContext, req: Request):
    """als/AllUserIDs.java:34."""
    return sorted(_model(ctx).all_user_ids())


# -- writes ------------------------------------------------------------------


@resource("POST", "/pref/{userID}/{itemID}")
def set_preference(ctx: ServingContext, req: Request):
    """Body is the strength value; writes a 'user,item,value' input event
    (als/Preference.java:42-62)."""
    check_not_read_only(ctx)
    user, item = req.params["userID"], req.params["itemID"]
    body = req.text().strip()
    value = 1.0 if not body else _parse_float(body)
    send_input(ctx, join_csv([user, item, value]))
    return Response(204)


@resource("DELETE", "/pref/{userID}/{itemID}")
def delete_preference(ctx: ServingContext, req: Request):
    """Empty value = delete marker (als/Preference.java)."""
    check_not_read_only(ctx)
    user, item = req.params["userID"], req.params["itemID"]
    send_input(ctx, join_csv([user, item, ""]))
    model = ctx.model_manager.get_model() if ctx.model_manager else None
    if model is not None:
        model.remove_known_item(user, item)
    return Response(204)


def _parse_float(s: str) -> float:
    try:
        v = float(s)
    except ValueError:
        raise OryxServingException(400, f"bad value {s!r}")
    if math.isnan(v) or math.isinf(v):
        raise OryxServingException(400, f"bad value {s!r}")
    return v


@resource("POST", "/ingest")
def ingest(ctx: ServingContext, req: Request):
    """Bulk input: text, gzip, zip, or multipart (als/Ingest.java:61-72),
    the body's lines in one ``send_many``."""
    check_not_read_only(ctx)
    send_inputs(ctx, read_ingest_lines(req))
    return Response(204)


# ---------------------------------------------------------------------------
# Console (als/Console.java:28 — HTML page at / and /index.html)
# ---------------------------------------------------------------------------

from oryx_tpu_torch.serving.console import ConsoleForm, console_response, render_console  # noqa: E402

_CONSOLE_FORMS = [
    ConsoleForm("Recommend to a user", "GET", "/recommend/{userID}",
                query=("howMany", "offset", "considerKnownItems")),
    ConsoleForm("Recommend to many users", "GET", "/recommendToMany/{userIDs:+}",
                query=("howMany", "considerKnownItems"), note="separate user IDs with /"),
    ConsoleForm("Recommend to anonymous", "GET", "/recommendToAnonymous/{itemValuePairs:+}",
                query=("howMany",), note="item=value pairs separated with /"),
    ConsoleForm("Similar items", "GET", "/similarity/{itemIDs:+}", query=("howMany",)),
    ConsoleForm("Similarity to item", "GET", "/similarityToItem/{toItemID}/{itemIDs:+}"),
    ConsoleForm("Estimate preference", "GET", "/estimate/{userID}/{itemIDs:+}"),
    ConsoleForm("Because", "GET", "/because/{userID}/{itemID}", query=("howMany",)),
    ConsoleForm("Known items", "GET", "/knownItems/{userID}"),
    ConsoleForm("Most popular items", "GET", "/mostPopularItems", query=("howMany",)),
    ConsoleForm("Most active users", "GET", "/mostActiveUsers", query=("howMany",)),
    ConsoleForm("Set preference", "POST", "/pref/{userID}/{itemID}", body=True,
                note="optional strength value in the body"),
    ConsoleForm("Ingest", "POST", "/ingest", body=True,
                note="user,item,strength CSV lines"),
    ConsoleForm("Ready?", "GET", "/ready"),
]

_CONSOLE_HTML = render_console("Oryx ALS serving console", _CONSOLE_FORMS)


@resource("GET", "/")
@resource("GET", "/index.html")
def console(ctx: ServingContext, req: Request):
    return console_response(_CONSOLE_HTML)
