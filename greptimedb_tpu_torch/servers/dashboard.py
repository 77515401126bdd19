"""Embedded web dashboard (reference: servers/src/http dashboard feature
serving the bundled GreptimeDB dashboard UI). A single self-contained
page: SQL/PromQL query box, results table, and a canvas chart for
timestamp+numeric result shapes — no external assets (zero-egress
deployments included)."""

PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>greptimedb_tpu dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
         margin: 2rem auto; max-width: 72rem; padding: 0 1rem; }
  h1 { font-size: 1.1rem; }
  textarea { width: 100%; height: 6rem; font: inherit; padding: .5rem;
             box-sizing: border-box; }
  .row { display: flex; gap: .5rem; margin: .5rem 0; align-items: center; }
  button { font: inherit; padding: .35rem 1rem; cursor: pointer; }
  table { border-collapse: collapse; margin-top: 1rem; font-size: .85rem; }
  th, td { border: 1px solid #8884; padding: .25rem .6rem; text-align: left; }
  th { background: #8881; }
  #meta { opacity: .7; font-size: .8rem; }
  #err { color: #c33; white-space: pre-wrap; }
  canvas { width: 100%; height: 260px; margin-top: 1rem; }
  select, input[type=text] { font: inherit; padding: .3rem; }
</style>
</head>
<body>
<h1>greptimedb_tpu</h1>
<div class="row">
  <select id="mode">
    <option value="sql">SQL</option>
    <option value="promql">PromQL</option>
  </select>
  <input type="text" id="db" value="public" size="10" title="database">
  <span id="meta"></span>
</div>
<textarea id="q" spellcheck="false">SELECT * FROM information_schema.tables LIMIT 20</textarea>
<div class="row">
  <button onclick="run()">Run (Ctrl-Enter)</button>
  <label>start <input type="text" id="start" size="12" placeholder="promql"></label>
  <label>end <input type="text" id="end" size="12"></label>
  <label>step <input type="text" id="step" size="6" value="60s"></label>
</div>
<div id="err"></div>
<div id="out"></div>
<canvas id="chart" width="1100" height="260" style="display:none"></canvas>
<script>
const $ = (id) => document.getElementById(id);
$("q").addEventListener("keydown", (e) => {
  if ((e.ctrlKey || e.metaKey) && e.key === "Enter") run();
});
async function run() {
  $("err").textContent = ""; $("out").innerHTML = "";
  $("chart").style.display = "none";
  const q = $("q").value, t0 = performance.now();
  let url;
  if ($("mode").value === "sql") {
    url = "/v1/sql?" + new URLSearchParams({sql: q, db: $("db").value});
  } else {
    url = "/v1/prometheus/api/v1/query_range?" + new URLSearchParams({
      query: q, start: $("start").value || "0",
      end: $("end").value || String(Math.floor(Date.now()/1000)),
      step: $("step").value || "60s", db: $("db").value});
  }
  let body;
  try { body = await (await fetch(url)).json(); }
  catch (e) { $("err").textContent = String(e); return; }
  const ms = (performance.now() - t0).toFixed(1);
  if ($("mode").value === "sql") renderSql(body, ms); else renderProm(body, ms);
}
function renderSql(body, ms) {
  if (body.error) { $("err").textContent = body.error; return; }
  const out = body.output && body.output[0];
  if (!out) return;
  if (out.affectedrows !== undefined) {
    $("out").textContent = `OK, ${out.affectedrows} rows affected (${ms} ms)`;
    return;
  }
  const rec = out.records, cols = rec.schema.column_schemas.map(c => c.name);
  $("meta").textContent = `${rec.rows.length} rows in ${ms} ms`;
  const tbl = document.createElement("table");
  tbl.innerHTML = "<tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") +
    "</tr>" + rec.rows.map(r => "<tr>" +
      r.map(v => `<td>${esc(v)}</td>`).join("") + "</tr>").join("");
  $("out").appendChild(tbl);
  chartIfSeries(cols, rec.rows, rec.schema.column_schemas);
}
function renderProm(body, ms) {
  if (body.status !== "success") {
    $("err").textContent = JSON.stringify(body); return;
  }
  const result = body.data.result || [];
  $("meta").textContent = `${result.length} series in ${ms} ms`;
  const series = result.map(s => ({
    label: JSON.stringify(s.metric),
    pts: (s.values || [s.value]).map(([t, v]) => [Number(t)*1000, Number(v)]),
  }));
  drawChart(series);
  const tbl = document.createElement("table");
  tbl.innerHTML = "<tr><th>series</th><th>points</th></tr>" +
    result.map(s => `<tr><td>${esc(JSON.stringify(s.metric))}</td>` +
      `<td>${(s.values||[]).length}</td></tr>`).join("");
  $("out").appendChild(tbl);
}
function chartIfSeries(cols, rows, schemas) {
  const ti = schemas.findIndex(c => (c.data_type||"").startsWith("timestamp"));
  const vi = schemas.findIndex(c => ["float64","float32","int64","int32"]
    .includes(c.data_type));
  if (ti < 0 || vi < 0 || rows.length < 2) return;
  drawChart([{label: cols[vi],
              pts: rows.map(r => [Date.parse(r[ti]) || Number(r[ti]),
                                  Number(r[vi])])}]);
}
function drawChart(series) {
  if (!series.length || !series[0].pts.length) return;
  const cv = $("chart"), ctx = cv.getContext("2d");
  cv.style.display = "block";
  ctx.clearRect(0, 0, cv.width, cv.height);
  let xs = [], ys = [];
  series.forEach(s => s.pts.forEach(([x, y]) => {
    if (isFinite(x) && isFinite(y)) { xs.push(x); ys.push(y); }}));
  if (!xs.length) return;
  const x0 = Math.min(...xs), x1 = Math.max(...xs) || x0 + 1;
  const y0 = Math.min(...ys), y1 = Math.max(...ys) || y0 + 1;
  const X = x => 40 + (x - x0) / (x1 - x0 || 1) * (cv.width - 60);
  const Y = y => cv.height - 20 - (y - y0) / (y1 - y0 || 1) * (cv.height - 40);
  ctx.strokeStyle = "#8886"; ctx.strokeRect(40, 10, cv.width - 60, cv.height - 30);
  const hues = [210, 30, 120, 280, 0, 60];
  series.slice(0, 12).forEach((s, i) => {
    ctx.strokeStyle = `hsl(${hues[i % 6]} 70% 50%)`;
    ctx.beginPath();
    s.pts.forEach(([x, y], j) =>
      j ? ctx.lineTo(X(x), Y(y)) : ctx.moveTo(X(x), Y(y)));
    ctx.stroke();
  });
  ctx.fillStyle = "#888"; ctx.font = "11px monospace";
  ctx.fillText(String(y1), 2, Y(y1) + 4);
  ctx.fillText(String(y0), 2, Y(y0) + 4);
}
function esc(v) {
  return String(v === null ? "NULL" : v)
    .replace(/&/g, "&amp;").replace(/</g, "&lt;");
}
</script>
</body>
</html>
"""
