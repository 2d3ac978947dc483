"""Static HTML consoles for Serving Layer applications.

Rebuilds the reference's console tier (AbstractConsoleResource.java:
header + app fragment + footer served as one HTML page at ``/`` and
``/index.html`` with ``X-Frame-Options: SAMEORIGIN`` and
``Cache-Control: public``; per-app subclasses als/Console.java:28,
kmeans/Console.java:28, rdf/Console.java:28). Instead of shipping HTML
fragment files, apps declare their endpoints as :class:`ConsoleForm`
specs and the page is generated — same header/footer framing, same
endpoint-exercising forms.

Port note: a copy of ``oryx_tpu/serving/console.py``, with its imports
pointed at ``oryx_tpu_torch``; each app's page is the JAX package's byte
for byte.
"""

from __future__ import annotations

import html as _html
from dataclasses import dataclass, field

from oryx_tpu_torch.serving.web import Response

__all__ = ["ConsoleForm", "console_response", "render_console"]


@dataclass
class ConsoleForm:
    """One endpoint form on the console page.

    ``path`` may contain ``{placeholders}``; each becomes a text input
    whose value is substituted client-side before the request is sent.
    ``query`` names become optional query-string inputs. ``body`` adds a
    textarea posted as the request body (e.g. /ingest).
    """

    legend: str
    method: str = "GET"
    path: str = "/"
    query: tuple[str, ...] = ()
    body: bool = False
    note: str = ""


_STYLE = """
body { font-family: sans-serif; margin: 2em; color: #222; }
h1 { border-bottom: 2px solid #c60; padding-bottom: .2em; }
fieldset { margin: 1em 0; border: 1px solid #bbb; }
legend { font-weight: bold; }
code { background: #f4f4f4; padding: 0 .3em; }
input[type=text] { margin: .2em; }
pre.out { background: #f8f8f8; border: 1px solid #ddd; padding: .5em;
          max-height: 12em; overflow: auto; white-space: pre-wrap; }
.note { color: #666; font-size: .9em; }
footer { margin-top: 2em; border-top: 1px solid #bbb; color: #666;
         font-size: .85em; padding-top: .5em; }
"""

_SCRIPT = """
function contextPrefix() {
  let p = window.location.pathname;
  if (p.endsWith('index.html')) p = p.slice(0, p.length - 'index.html'.length);
  if (p.endsWith('/')) p = p.slice(0, p.length - 1);
  return p;
}
async function go(formEl, method, template, hasBody) {
  let path = template;
  const qs = [];
  for (const el of formEl.querySelectorAll('input[type=text]')) {
    const greedy = '{' + el.name + ':+}';
    const single = '{' + el.name + '}';
    if (template.includes(greedy)) {
      // greedy params are multi-segment: keep '/' as a separator, encode
      // each segment (the server splits on raw '/' before decoding)
      const enc = el.value.split('/').map(encodeURIComponent).join('/');
      path = path.replace(greedy, enc);
    } else if (template.includes(single)) {
      path = path.replace(single, encodeURIComponent(el.value));
    } else if (el.value !== '') {
      qs.push(encodeURIComponent(el.name) + '=' + encodeURIComponent(el.value));
    }
  }
  path = contextPrefix() + path;
  if (qs.length) path += '?' + qs.join('&');
  const opts = {method: method, headers: {'Accept': 'application/json'}};
  const ta = formEl.querySelector('textarea');
  if (hasBody && ta) { opts.body = ta.value; opts.headers['Content-Type'] = 'text/plain'; }
  const out = formEl.querySelector('pre.out');
  try {
    const resp = await fetch(path, opts);
    out.textContent = resp.status + ' ' + (await resp.text());
  } catch (e) {
    out.textContent = 'error: ' + e;
  }
  return false;
}
"""


def _form_html(form: ConsoleForm) -> str:
    inputs = []
    seen = set()
    path = form.path
    i = 0
    while True:
        i = path.find("{", i)
        if i < 0:
            break
        j = path.find("}", i)
        name = path[i + 1 : j].split(":")[0]
        if name not in seen:
            seen.add(name)
            inputs.append(name)
        i = j + 1
    for q in form.query:
        if q not in seen:
            seen.add(q)
            inputs.append(q)
    template = form.path
    rows = "".join(
        f'<label>{_html.escape(n)} <input type="text" name="{_html.escape(n)}"></label>'
        for n in inputs
    )
    body_area = '<br><textarea rows="3" cols="60"></textarea>' if form.body else ""
    note = f'<div class="note">{_html.escape(form.note)}</div>' if form.note else ""
    return (
        f"<fieldset><legend>{_html.escape(form.legend)}</legend>"
        f"<code>{_html.escape(form.method)} {_html.escape(form.path)}</code> {note}"
        f'<form onsubmit="go(this, {form.method!r}, {template!r}, {str(form.body).lower()}); return false">'
        f"{rows}{body_area} <input type=\"submit\" value=\"Send\">"
        '<pre class="out"></pre></form></fieldset>'
    )


def render_console(title: str, forms: list[ConsoleForm]) -> str:
    """Full console page: common header + app forms + common footer
    (the reference's console-header/app-fragment/console-footer
    concatenation, AbstractConsoleResource.java loadHTML)."""
    body = "".join(_form_html(f) for f in forms)
    return (
        "<!doctype html><html><head><meta charset=\"utf-8\">"
        f"<title>{_html.escape(title)}</title>"
        f"<style>{_STYLE}</style><script>{_SCRIPT}</script></head>"
        f"<body><h1>{_html.escape(title)}</h1>"
        "<p>Serving Layer console — exercise the application's REST "
        "endpoints below, or call them directly.</p>"
        f"{body}"
        "<footer>oryx_tpu serving layer</footer></body></html>"
    )


def console_response(html: str) -> Response:
    """Response with the reference's console headers
    (AbstractConsoleResource.java getHTML)."""
    return Response(
        200,
        html,
        content_type="text/html",
        headers={"X-Frame-Options": "SAMEORIGIN", "Cache-Control": "public"},
    )
