"""Execute the studio frontend (app.js) against a live server.

The hand-written WebGL/SSE/gizmo frontend was once only grep-tested.
Here it actually RUNS: ``tests/jsmini``
interprets ``studio/static/app.js`` inside a browser host
(``tests/jsdom``) whose ``fetch``/``EventSource`` talk to the real
stdlib HTTP server — so boot, document apply, the WebGL viewport
(tessellation, buffer uploads, draw calls), the inspector, a full SSE
run with live plots, and the drag-gizmo → move-patch loop all execute
end-to-end. Any exercised app.js function that throws fails the test.
"""
import os
import threading

import pytest
import yaml

import pvtrace_tpu.studio.server as studio_server
from jsdom import BrowserHarness, make_event
from jsmini import Interpreter, UNDEF, js_str, to_python

DATA = os.path.join(os.path.dirname(__file__), "data")
STATIC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pvtrace_tpu", "studio", "static",
)


@pytest.fixture(scope="module")
def server():
    document = os.path.join(DATA, "lsc_scene_studio.yml")
    httpd = studio_server.create_server(document, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    yield base, httpd
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5)


@pytest.fixture(scope="module")
def booted(server):
    """Interpreter + harness with app.js fully booted (document loaded,
    scene applied, viewport drawn)."""
    base, httpd = server
    with open(os.path.join(STATIC, "index.html")) as fp:
        index_html = fp.read()
    with open(os.path.join(STATIC, "app.js")) as fp:
        app_js = fp.read()
    harness = BrowserHarness(base, index_html, webgl=True)
    interp = Interpreter(max_steps=300_000_000)
    harness.install(interp)
    interp.run(app_js)  # executes boot() at the bottom of the file
    return interp, harness, httpd


def test_boot_loads_and_applies_document(booted):
    interp, harness, httpd = booted
    state = interp.get("state")
    assert state["scene"] is not UNDEF and state["scene"] is not None
    names = {js_str(n["name"]) for n in state["scene"]["nodes"]}
    assert {"world", "lsc"} <= names
    # The editor holds the document text fetched from the server.
    assert "lsc" in js_str(harness.el("editor")["value"])
    methods = [(m, u) for m, u, _s in harness.network]
    assert ("GET", "/api/document") in methods
    assert any(m == "PUT" and u == "/api/document" for m, u in methods)


def test_webgl_viewport_draws_geometry(booted):
    interp, harness, _httpd = booted
    gl = harness.el("viewport-gl")._gl
    assert gl is not None, "webgl context was never requested"
    # Three shader programs (solid, line, tex) were compiled.
    assert len(gl.shader_sources) == 6
    # Geometry was tessellated and uploaded: the lsc box is 12 tris x 3
    # verts x 6 floats = 216 floats; the world sphere far more.
    assert any(n >= 216 for n in gl.buffer_uploads)
    # And drawn with TRIANGLES.
    assert any(mode == 4.0 and count > 0 for mode, count in gl.draw_calls)


def test_overlay_canvas_draws_axes_and_wireframes(booted):
    interp, harness, _httpd = booted
    context = harness.el("viewport")._context2d
    assert context is not None
    assert context.count("stroke") > 3  # axes + wireframe edges
    assert context.count("clearRect") >= 1


def test_inspector_lists_nodes_and_recorders(booted):
    interp, harness, _httpd = booted
    rows = harness.el("nodes")["children"]
    labels = [js_str(row["children"][0]["textContent"]) for row in rows]
    assert any("world" in label for label in labels)
    assert any("lsc" in label for label in labels)
    # record: true on the lsc node materialises auto recorders.
    assert len(harness.el("recorders")["children"]) > 0


def test_run_streams_live_results_and_plots(booted):
    interp, harness, httpd = booted
    harness.el("rays")["value"] = "2000"
    harness.el("bundle")["value"] = "1000"
    harness.el("seed")["value"] = "7"
    interp.call_any(harness.el("run")["onclick"], [])
    assert interp.get("state")["running"] is True
    source = harness.event_sources[-1]
    assert source.url.startswith("/api/run?")
    assert "rays=2000" in source.url and "seed=7" in source.url
    dispatched = source.pump()
    assert dispatched >= 3  # started + >=1 bundle + done
    state = interp.get("state")
    assert state["running"] is False
    assert state["recorders"] is not UNDEF
    assert "done in" in js_str(harness.el("status")["textContent"])
    assert "rays/s" in js_str(harness.el("rate")["textContent"])
    # Live plots were painted: one canvas per histogram, bars filled.
    plots = harness.el("plots")["children"]
    assert len(plots) > 0
    bar_fills = sum(
        plot["children"][1]._context2d.count("fillRect")
        for plot in plots
        if plot["children"][1].get("_ctx_missing") is None
        and plot["children"][1]._context2d is not None
    )
    heatmap_draws = sum(
        plot["children"][1]._context2d.count("drawImage")
        for plot in plots
        if plot["children"][1]._context2d is not None
    )
    assert bar_fills + heatmap_draws > 0


def test_gizmo_drag_posts_move_patch(booted):
    interp, harness, httpd = booted
    # Select the lsc node by clicking its inspector row.
    rows = harness.el("nodes")["children"]
    target = next(
        row for row in rows
        if js_str(row["children"][0]["textContent"]) == "lsc"
    )
    interp.call_any(target["children"][0]["onclick"], [])
    assert js_str(interp.get("state")["selected"]) == "lsc"

    # Project the gizmo origin to screen space using app.js's own math.
    node = interp.call("selectedNode")
    origin = interp.call("nodeOrigin", node)
    canvas = harness.el("viewport")
    p = interp.call("project", origin, canvas["width"], canvas["height"])
    assert p is not UNDEF and p is not None

    before = yaml.safe_load(httpd.studio.document)
    location_before = before["nodes"]["lsc"]["location"]

    canvas.dispatch("mousedown", make_event(
        "mousedown", clientX=p[0], clientY=p[1]
    ))
    assert interp.get("state")["gizmo"] is not UNDEF
    assert to_python(interp.get("state")["gizmo"]) is not None
    harness.window_dispatch("mousemove", clientX=p[0] + 30, clientY=p[1])
    harness.window_dispatch("mouseup")

    # The drag posted an op:move patch and the document moved the node.
    assert any(
        m == "POST" and u == "/api/patch" for m, u, _s in harness.network
    )
    after = yaml.safe_load(httpd.studio.document)
    assert after["nodes"]["lsc"]["location"] != location_before


def test_add_recorder_button_patches_document(booted):
    interp, harness, httpd = booted
    rows = harness.el("nodes")["children"]
    target = next(
        row for row in rows
        if js_str(row["children"][0]["textContent"]) == "lsc"
    )
    if js_str(interp.get("state")["selected"]) != "lsc":
        interp.call_any(target["children"][0]["onclick"], [])
    # Re-rendered inspector: find the "+ recorder" button on the row.
    rows = harness.el("nodes")["children"]
    target = next(
        row for row in rows
        if js_str(row["children"][0]["textContent"]) == "lsc"
    )
    buttons = [
        child for container in target["children"]
        for child in (container["children"]
                      if isinstance(container.get("children"), list) else [])
        if js_str(child.get("tagName", "")) == "BUTTON"
    ]
    add = next(
        b for b in buttons if js_str(b["textContent"]) == "+ recorder"
    )
    interp.call_any(add["onclick"], [])
    spec = yaml.safe_load(httpd.studio.document)
    assert any(
        name.startswith("lsc-escaping") for name in spec.get("recorders", {})
    )


def test_editor_error_shown_for_invalid_document(booted):
    interp, harness, _httpd = booted
    interp.call("applyDocument", "nodes: [broken")
    assert js_str(harness.el("editor-error")["textContent"]) != ""
    # Recover with the current server copy so later tests see a scene.
    interp.call("applyDocument", js_str(harness.el("editor")["value"]))
    assert js_str(harness.el("editor-error")["textContent"]) == ""


def test_add_node_buttons_wired(booted):
    interp, harness, httpd = booted
    box_button = next(
        b for b in harness.data_add_buttons
        if js_str(b["dataset"]["add"]) == "box"
    )
    interp.call_any(box_button["onclick"], [])
    spec = yaml.safe_load(httpd.studio.document)
    assert "box-1" in spec["nodes"]
    # clean up so other module-scoped tests keep a small scene
    import jsmini

    interp.call("patch", jsmini.from_python(
        {"op": "delete-node", "node": "box-1"}
    ))
    spec = yaml.safe_load(httpd.studio.document)
    assert "box-1" not in spec["nodes"]


def test_editor_syntax_highlighting(booted):
    """The comment-free CodeMirror replacement: a tokenised <pre> under
    the transparent textarea, refreshed on boot, patches and typing."""
    interp, harness, _httpd = booted
    html = js_str(harness.el("editor-highlight")["innerHTML"])
    assert '<span class="tok-key">' in html
    assert '<span class="tok-num">' in html

    line = js_str(interp.call(
        "highlightLine", "coefficient: 5.0  # dye strength"
    ))
    assert '<span class="tok-key">coefficient</span>' in line
    assert '<span class="tok-num">5.0</span>' in line
    assert '<span class="tok-comment"># dye strength</span>' in line
    quoted = js_str(interp.call(
        "highlightLine", 'name: "lumogen-f-red-305"'
    ))
    assert '<span class="tok-str">&quot;' not in quoted  # no double-escape
    assert 'tok-str' in quoted
    flow = js_str(interp.call("highlightLine", "  facet: [0, 0, -1]"))
    assert 'tok-punct' in flow and flow.count("tok-num") == 3
    escaped = js_str(interp.call("highlightLine", "a: <b> & 'c'"))
    assert "&lt;b&gt;" in escaped and "&amp;" in escaped

    # Typing refreshes the overlay.
    original = js_str(harness.el("editor")["value"])
    harness.el("editor")["value"] = "version: '2.0'  # note"
    harness.el("editor").dispatch("input")
    html = js_str(harness.el("editor-highlight")["innerHTML"])
    assert "tok-comment" in html and "tok-str" in html
    interp.call("setEditorValue", original)  # restore for other tests


def test_highlighter_hash_inside_scalar_is_not_a_comment(booted):
    interp, _harness, _httpd = booted
    line = js_str(interp.call("highlightLine", "url: http://x#frag"))
    assert "tok-comment" not in line
    line = js_str(interp.call("highlightLine", "a: 1  # real comment"))
    assert "tok-comment" in line


def test_watch_mode_subscribes_to_broadcast_feed(server):
    """Booting with ?watch=1 (the CLI `simulate --watch` live view)
    must attach the shared SSE consumer to /api/watch."""
    base, _httpd = server
    with open(os.path.join(STATIC, "index.html")) as fp:
        index_html = fp.read()
    with open(os.path.join(STATIC, "app.js")) as fp:
        app_js = fp.read()
    harness = BrowserHarness(base, index_html, search="?watch=1")
    interp = Interpreter(max_steps=300_000_000)
    harness.install(interp)
    interp.run(app_js)
    assert harness.event_sources, "watch mode never opened an EventSource"
    assert harness.event_sources[-1].url == "/api/watch"
    assert interp.get("state")["running"] is True
