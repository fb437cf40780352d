"""Dashboard HTTP server: heartbeat sink + REST API + minimal console page.

Analog of the Spring Boot side of ``sentinel-dashboard``:
``MachineRegistryController`` (``/registry/machine``), metric queries over
the in-memory repository, and rule CRUD proxied to app command centers
(``FlowControllerV1`` + ``SentinelApiClient``). Runs on the stdlib
threading HTTP server — the console is an ops tool, not a hot path.
"""

from __future__ import annotations

import hmac
import json
import secrets
import threading
from typing import Optional, Tuple

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.httpd import (
    HttpService,
    Response,
    html_response,
    json_response,
)
from sentinel_tpu_torch.dashboard.api_client import ApiClient, CommandFailed
from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.fetcher import MetricFetcher
from sentinel_tpu_torch.dashboard.repository import InMemoryMetricsRepository
from sentinel_tpu_torch.dashboard.rules_repo import InMemoryRuleRepository
from sentinel_tpu_torch.dashboard.validation import validate_rule

RULE_TYPES = ("flow", "degrade", "system", "authority", "paramFlow", "gateway")

# Paths reachable without a session when auth is enabled: machine heartbeats
# (apps can't log in) and the login exchange itself + the console shell,
# which renders a login form client-side (same exclusions as the
# reference's LoginAuthenticationFilter).
AUTH_EXEMPT = {"registry/machine", "auth/login", "", "index.html"}

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>sentinel-tpu console</title>
<style>
 :root{color-scheme:light;
  --surface-1:#fcfcfb; --text-primary:#0b0b0b; --text-secondary:#52514e;
  --series-1:#2a78d6; --series-2:#eb6834; --series-3:#7b5cd6;
  --grid:#e4e3df; --border:#ccc}
 @media (prefers-color-scheme: dark){
  :root{color-scheme:dark;
   --surface-1:#1a1a19; --text-primary:#ffffff; --text-secondary:#c3c2b7;
   --series-1:#3987e5; --series-2:#d95926; --series-3:#9b7ff0;
   --grid:#33332f; --border:#444}}
 body{font-family:system-ui,sans-serif;margin:2rem;color:var(--text-primary);
  background:var(--surface-1)}
 h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.5rem}
 h3{font-size:.95rem;margin:.8rem 0 .3rem}
 table{border-collapse:collapse;min-width:40rem}
 th,td{border:1px solid var(--border);padding:.35rem .6rem;text-align:left;
  font-size:.9rem}
 th{background:color-mix(in srgb, var(--text-primary) 6%, var(--surface-1))}
 .dead{color:#b00} .ok{color:#070}
 input,select{margin:.1rem .2rem .1rem 0}
 .tab{margin-right:.3rem} .tab.on{font-weight:bold;text-decoration:underline}
 #chartwrap{margin-top:1rem} .legend{font-size:.85rem;color:var(--text-secondary)}
 .legend b{font-weight:600;color:var(--text-primary)}
 .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
  vertical-align:baseline;margin:0 .3rem 0 .8rem}
 #tip{position:absolute;pointer-events:none;background:var(--surface-1);
  border:1px solid var(--border);padding:.25rem .5rem;font-size:.8rem;
  display:none;border-radius:4px}
</style></head><body>
<h1>sentinel-tpu console</h1>
<div id="login" style="display:none">
 <h2>login</h2>
 <input id="u" placeholder="username"> <input id="p" type="password"
  placeholder="password"> <button onclick="login()">sign in</button>
 <span id="loginmsg" class="dead"></span>
</div>
<div class="legend" id="resfilterwrap" style="display:none">filter resources
 <input id="resfilter" oninput="filterChanged()" placeholder="substring"></div>
<div id="apps"></div>
<div id="ruled" style="display:none">
 <h2>rules: <span id="ruleapp"></span></h2>
 <div id="ruletabs"></div>
 <div id="ruleview"></div>
 <span id="rulemsg" class="legend"></span>
</div>
<div id="clusterd" style="display:none">
 <h2>cluster monitor: <span id="clusterapp"></span></h2>
 <div id="clusterview"></div>
</div>
<div id="machined" style="display:none">
 <h2>machine: <span id="machineres"></span></h2>
 <div id="machineview"></div>
</div>
<div id="chartwrap" style="display:none">
 <h2>timeline: <span id="chartres"></span></h2>
 <div class="legend">machine <select id="chartmachine"
   onchange="chartCtx.machine=this.value;loadChart()"></select>
  window <select id="chartwin" onchange="loadChart()">
   <option value="60000">1 min</option>
   <option value="180000">3 min</option>
   <option value="300000" selected>5 min</option></select></div>
 <div class="legend"><span class="sw" style="background:var(--series-1)"></span>
  <b>pass qps</b><span class="sw" style="background:var(--series-2)"></span>
  <b>block qps</b><span class="sw" style="background:var(--series-3)"></span>
  <b>exception qps</b></div>
 <svg id="chart" width="720" height="220" role="img"
  aria-label="pass, block and exception qps over time"></svg>
 <div class="legend"><span class="sw" style="background:var(--series-1)"></span>
  <b>avg rt (ms)</b></div>
 <svg id="rtchart" width="720" height="140" role="img"
  aria-label="average response time over time"></svg>
 <div id="tip"></div>
</div>
<script>
// resource names and machine fields are attacker-influenced (a resource is
// often a raw request path) — build rows with textContent only, never
// string-interpolated HTML
const RULE_TYPES = ['flow','degrade','system','authority','paramFlow','gateway'];
// editable fields per rule type, in the agent's JSON schema
const SCHEMAS = {
 flow: ['resource','count','grade','limitApp','strategy','refResource',
        'controlBehavior','warmUpPeriodSec','maxQueueingTimeMs','clusterMode'],
 degrade: ['resource','grade','count','timeWindow','minRequestAmount',
           'statIntervalMs','slowRatioThreshold','limitApp'],
 system: ['highestSystemLoad','highestCpuUsage','qps','avgRt','maxThread'],
 authority: ['resource','limitApp','strategy'],
 paramFlow: ['resource','paramIdx','count','grade','durationInSec',
             'burstCount','controlBehavior','maxQueueingTimeMs',
             'paramFlowItemList'],
 gateway: ['resource','resourceMode','count','grade','intervalSec',
           'controlBehavior','burst','maxQueueingTimeoutMs','paramItem'],
};
let curApp = '', curType = 'flow', editId = null;
function row(table, cells, tag){
  const tr = document.createElement('tr');
  for (const c of cells){
    const td = document.createElement(tag || 'td');
    if (c && c.nodeType) td.appendChild(c);
    else if (c && typeof c === 'object' && c.cls !== undefined){
      td.textContent = c.text; td.className = c.cls;
    }
    else td.textContent = c;
    tr.appendChild(td);
  }
  table.appendChild(tr);
}
async function api(path){
  const r = await fetch(path);
  if (r.status === 401){ showLogin(); throw new Error('auth'); }
  return r.json();
}
function showLogin(){ document.getElementById('login').style.display=''; }
async function login(){
  const body = JSON.stringify({username: u.value, password: p.value});
  const r = await fetch('auth/login', {method:'POST', body});
  if (r.status === 200){ login_el().style.display='none'; refresh(); }
  else document.getElementById('loginmsg').textContent = 'invalid credentials';
}
function login_el(){ return document.getElementById('login'); }
function openRules(app){
  curApp = app;
  document.getElementById('ruled').style.display='';
  document.getElementById('ruleapp').textContent = app;
  const tabs = document.getElementById('ruletabs');
  tabs.innerHTML = '';
  for (const t of RULE_TYPES){
    const b = document.createElement('button');
    b.textContent = t; b.className = 'tab' + (t===curType?' on':'');
    b.onclick = () => { curType = t; editId = null; openRules(curApp); };
    tabs.appendChild(b);
  }
  const ab = document.createElement('button');
  ab.textContent = 'api groups'; ab.className = 'tab' + (curType==='apiGroups'?' on':'');
  ab.onclick = () => { curType = 'apiGroups'; openRules(curApp); };
  tabs.appendChild(ab);
  if (curType === 'apiGroups') loadApiGroups(); else loadRules();
}
function coerce(text){
  if (text === '') return undefined;
  if (text === 'true') return true;
  if (text === 'false') return false;
  if (text[0] === '{' || text[0] === '[') {
    try { return JSON.parse(text); } catch(e) { return text; }
  }
  const n = Number(text);
  return Number.isNaN(n) ? text : n;
}
function fieldValue(rule, f){
  const v = rule[f];
  if (v === undefined || v === null) return '';
  return (typeof v === 'object') ? JSON.stringify(v) : String(v);
}
let lastRules = [];
async function loadRules(){
  if (curType === 'apiGroups') return loadApiGroups();
  const qs = `app=${encodeURIComponent(curApp)}&type=${encodeURIComponent(curType)}`;
  let rules = [];
  try { rules = await api('v1/rules?' + qs); } catch(e){}
  if (!Array.isArray(rules)) rules = [];
  lastRules = rules;
  renderView();
}
// render from lastRules WITHOUT re-fetching: a v1/rules fetch re-syncs the
// dashboard repository and assigns fresh ids, which would orphan the id an
// in-progress edit captured
function renderView(fill){
  const fields = SCHEMAS[curType];
  if (!fields) return;  // non-CRUD tab (apiGroups) owns #ruleview itself
  const qs = `app=${encodeURIComponent(curApp)}&type=${encodeURIComponent(curType)}`;
  const view = document.getElementById('ruleview');
  view.innerHTML = '';
  const table = document.createElement('table');
  row(table, ['id', ...fields, '', ''], 'th');
  for (const r of lastRules){
    const eb = document.createElement('button'); eb.textContent = 'edit';
    eb.onclick = () => { editId = r.id; renderView(r); };
    const db = document.createElement('button'); db.textContent = 'delete';
    db.onclick = async () => {
      const resp = await fetch(`v1/rule?${qs}&id=${r.id}`, {method:'DELETE'});
      msg(await resp.json()); loadRules();
    };
    row(table, [String(r.id), ...fields.map(f => fieldValue(r, f)), eb, db]);
  }
  view.appendChild(table);
  const form = document.createElement('div');
  const title = document.createElement('h3');
  title.textContent = editId === null ? 'add rule' : `edit rule ${editId}`;
  form.appendChild(title);
  for (const f of fields){
    const inp = document.createElement('input');
    inp.id = 'f_' + f; inp.placeholder = f; inp.size = Math.max(f.length, 8);
    if (fill) inp.value = fieldValue(fill, f);
    form.appendChild(inp);
  }
  const save = document.createElement('button');
  save.textContent = editId === null ? 'add' : 'save';
  save.onclick = async () => {
    const rule = {};
    for (const f of fields){
      const v = coerce(document.getElementById('f_' + f).value);
      if (v !== undefined) rule[f] = v;
    }
    const url = editId === null ? `v1/rule?${qs}`
      : `v1/rule?${qs}&id=${editId}`;
    const resp = await fetch(url, {
      method: editId === null ? 'POST' : 'PUT', body: JSON.stringify(rule)});
    msg(await resp.json()); editId = null; loadRules();
  };
  form.appendChild(save);
  if (editId !== null){
    const cancel = document.createElement('button');
    cancel.textContent = 'cancel';
    cancel.onclick = () => { editId = null; renderView(); };
    form.appendChild(cancel);
  }
  view.appendChild(form);
}
function msg(obj){
  document.getElementById('rulemsg').textContent = JSON.stringify(obj);
}
// gateway custom-API group editor (GatewayApiController analog): the
// definitions are a small nested structure, edited as a JSON document
async function loadApiGroups(){
  const view = document.getElementById('ruleview');
  view.innerHTML = '';
  let defs = null;
  try { defs = await api('v1/gateway/apis?app='+encodeURIComponent(curApp)); }
  catch(e){}
  if (!Array.isArray(defs)){
    // a failed fetch must NOT render an empty editor — saving it would
    // wipe every machine's live definitions (same guard as v1/rule's
    // seed-before-push)
    msg(defs || {error: 'fetching api groups failed'});
    const p = document.createElement('p');
    p.textContent = 'could not load live api groups; editor disabled';
    p.className = 'dead';
    view.appendChild(p);
    return;
  }
  const ta = document.createElement('textarea');
  ta.rows = 12; ta.cols = 80;
  ta.value = JSON.stringify(defs, null, 2);
  view.appendChild(ta);
  const hint = document.createElement('div');
  hint.className = 'legend';
  hint.textContent = 'array of {apiName, predicateItems: [{pattern, ' +
    'matchStrategy: 0 exact | 1 prefix | 2 regex}]}';
  view.appendChild(hint);
  const save = document.createElement('button');
  save.textContent = 'save api groups';
  save.onclick = async () => {
    let parsed;
    try { parsed = JSON.parse(ta.value); }
    catch(e){ msg({error: 'invalid JSON: ' + e.message}); return; }
    const r = await fetch('v1/gateway/apis?app='+encodeURIComponent(curApp),
      {method:'POST', body: JSON.stringify(parsed)});
    msg(await r.json());
  };
  view.appendChild(save);
}
async function assign(app, machine){
  const r = await fetch(`cluster/assign?app=${encodeURIComponent(app)}`,
    {method:'POST', body: JSON.stringify({server: machine})});
  alert(JSON.stringify(await r.json())); refresh();
}
// ---- metric timelines: qps chart (pass/block/exception) + rt chart ----
// per-machine drill-down + history window (metric.js analog): the machine
// selector switches between the app-wide sum and one machine's own series
let chartData = null;
let chartCtx = {app:'', resource:'', machine:''};
async function openChart(app, resource, machine){
  document.getElementById('chartwrap').style.display = '';
  chartCtx = {app, resource, machine: machine || ''};
  const sel = document.getElementById('chartmachine');
  sel.innerHTML = '';
  const all = document.createElement('option');
  all.value = ''; all.textContent = 'all machines (sum)';
  sel.appendChild(all);
  try {
    for (const mk of await api(`metric/machines?app=${encodeURIComponent(app)}` +
        `&identity=${encodeURIComponent(resource)}`)){
      const o = document.createElement('option');
      o.value = mk; o.textContent = mk; sel.appendChild(o);
    }
  } catch(e){}
  if (chartCtx.machine &&
      ![...sel.options].some(o => o.value === chartCtx.machine)){
    // the machines fetch failed or lagged: add the requested machine so
    // the selector always names the series actually plotted
    const o = document.createElement('option');
    o.value = chartCtx.machine; o.textContent = chartCtx.machine;
    sel.appendChild(o);
  }
  sel.value = chartCtx.machine;
  await loadChart();
}
// ---- per-machine resource view (identity.js analog) ----
let machineSeq = 0;
async function openMachine(app, mkey){
  const seq = ++machineSeq;  // a newer click supersedes this render
  const d = document.getElementById('machined');
  d.style.display = '';
  document.getElementById('machineres').textContent = mkey;
  const view = document.getElementById('machineview');
  view.innerHTML = '';
  const res = await api(`resources?app=${encodeURIComponent(app)}` +
    `&machine=${encodeURIComponent(mkey)}`);
  const now = Date.now();
  const series = await Promise.all(res.map(r =>
    api(`metric?app=${encodeURIComponent(app)}` +
      `&identity=${encodeURIComponent(r)}&machine=${encodeURIComponent(mkey)}` +
      `&startTime=${now-15000}&endTime=${now}`).catch(() => [])));
  if (seq !== machineSeq) return;  // superseded while fetching
  const t = document.createElement('table');
  row(t, ['resource', 'pass qps', 'block qps', 'rt ms', ''], 'th');
  res.forEach((r, i) => {
    const last = series[i][series[i].length-1] || {};
    const cb = document.createElement('button');
    cb.textContent = 'timeline';
    cb.onclick = () => openChart(app, r, mkey);
    row(t, [r, last.passQps??'', last.blockQps??'', last.rt??'', cb]);
  });
  view.appendChild(t);
  if (!res.length){
    const p = document.createElement('p');
    p.className = 'legend';
    p.textContent = 'no live samples from this machine';
    view.appendChild(p);
  }
}
async function loadChart(){
  const {app, resource, machine} = chartCtx;
  document.getElementById('chartres').textContent =
    resource + (machine ? ' @ ' + machine : '');
  const win = +document.getElementById('chartwin').value;
  const now = Date.now();
  const ms = await api(`metric?app=${encodeURIComponent(app)}` +
    `&identity=${encodeURIComponent(resource)}` +
    `&startTime=${now-win}&endTime=${now}` +
    (machine ? `&machine=${encodeURIComponent(machine)}` : ''));
  chartData = ms.map(e => ({t: e.timestamp, pass: e.passQps,
    block: e.blockQps, exc: e.exceptionQps, rt: e.rt}));
  drawChart();
}
const QPS_SERIES = [['pass','var(--series-1)'], ['block','var(--series-2)'],
                    ['exc','var(--series-3)']];
const RT_SERIES = [['rt','var(--series-1)']];
function drawChart(){
  renderChart(document.getElementById('chart'), 220, QPS_SERIES,
    d => 'pass ' + d.pass + '  block ' + d.block + '  exc ' + d.exc);
  renderChart(document.getElementById('rtchart'), 140, RT_SERIES,
    d => 'rt ' + d.rt + ' ms');
}
function renderChart(svg, H, series, fmt){
  svg.innerHTML = '';
  const NS = 'http://www.w3.org/2000/svg';
  const W = 720, L = 48, R = 10, T = 10, B = 24;
  const data = chartData || [];
  if (!data.length){
    const t = document.createElementNS(NS, 'text');
    t.setAttribute('x', W/2); t.setAttribute('y', H/2);
    t.setAttribute('text-anchor', 'middle');
    t.setAttribute('fill', 'var(--text-secondary)');
    t.textContent = 'no samples in the last 5 minutes';
    svg.appendChild(t); return;
  }
  const t0 = data[0].t, t1 = data[data.length-1].t || t0 + 1;
  const ymax = Math.max(1,
    ...data.map(d => Math.max(...series.map(([k]) => d[k] || 0))));
  const x = t => L + (W-L-R) * (t1 === t0 ? 0.5 : (t - t0)/(t1 - t0));
  const y = v => T + (H-T-B) * (1 - v/ymax);
  // recessive grid: 3 horizontal lines + y labels in secondary ink
  for (const f of [0, .5, 1]){
    const g = document.createElementNS(NS, 'line');
    g.setAttribute('x1', L); g.setAttribute('x2', W-R);
    g.setAttribute('y1', y(ymax*f)); g.setAttribute('y2', y(ymax*f));
    g.setAttribute('stroke', 'var(--grid)'); svg.appendChild(g);
    const lab = document.createElementNS(NS, 'text');
    lab.setAttribute('x', L-6); lab.setAttribute('y', y(ymax*f)+4);
    lab.setAttribute('text-anchor', 'end');
    lab.setAttribute('font-size', '11');
    lab.setAttribute('fill', 'var(--text-secondary)');
    lab.textContent = Math.round(ymax*f); svg.appendChild(lab);
  }
  for (const [key, color] of series){
    const pl = document.createElementNS(NS, 'polyline');
    pl.setAttribute('points',
      data.map(d => `${x(d.t)},${y(d[key] || 0)}`).join(' '));
    pl.setAttribute('fill', 'none');
    pl.setAttribute('stroke', color);
    pl.setAttribute('stroke-width', '2');
    pl.setAttribute('stroke-linejoin', 'round');
    svg.appendChild(pl);
  }
  // hover layer: nearest-sample crosshair + tooltip
  const hover = document.createElementNS(NS, 'rect');
  hover.setAttribute('x', L); hover.setAttribute('y', T);
  hover.setAttribute('width', W-L-R); hover.setAttribute('height', H-T-B);
  hover.setAttribute('fill', 'transparent');
  const cross = document.createElementNS(NS, 'line');
  cross.setAttribute('y1', T); cross.setAttribute('y2', H-B);
  cross.setAttribute('stroke', 'var(--text-secondary)');
  cross.setAttribute('stroke-dasharray', '3,3');
  cross.style.display = 'none';
  svg.appendChild(cross);
  const tip = document.getElementById('tip');
  hover.onmousemove = (ev) => {
    const rect = svg.getBoundingClientRect();
    const px = ev.clientX - rect.left;
    let best = data[0], bd = Infinity;
    for (const d of data){
      const dd = Math.abs(x(d.t) - px);
      if (dd < bd){ bd = dd; best = d; }
    }
    cross.setAttribute('x1', x(best.t)); cross.setAttribute('x2', x(best.t));
    cross.style.display = '';
    tip.style.display = 'block';
    tip.style.left = (ev.pageX + 12) + 'px';
    tip.style.top = (ev.pageY - 10) + 'px';
    tip.textContent = new Date(best.t).toLocaleTimeString() + '  ' + fmt(best);
  };
  hover.onmouseleave = () => {
    cross.style.display = 'none'; tip.style.display = 'none';
  };
  svg.appendChild(hover);
}
// ---- cluster monitor (cluster_app_server_monitor.js analog) ----
async function openCluster(app){
  document.getElementById('clusterd').style.display='';
  document.getElementById('clusterapp').textContent = app;
  const view = document.getElementById('clusterview');
  view.innerHTML = '';
  let mon;
  try { mon = await api('cluster/monitor?app='+encodeURIComponent(app)); }
  catch(e){ return; }
  for (const s of mon.servers || []){
    const h = document.createElement('h3');
    h.textContent = 'token server ' + s.machine +
      (s.info.port !== undefined ? ' (port ' + s.info.port + ')' : '');
    view.appendChild(h);
    const flow = s.info.flow || {};
    const ct = document.createElement('table');
    row(ct, ['namespaces', 'max allowed qps', 'interval ms', 'buckets',
             'embedded'], 'th');
    row(ct, [(s.info.namespaceSet || []).join(', '),
             String(flow.maxAllowedQps ?? ''),
             String(flow.intervalMs ?? ''),
             String(flow.sampleCount ?? ''),
             String(s.info.embedded ?? '')]);
    view.appendChild(ct);
    const conns = s.info.connection || [];
    const gt = document.createElement('table');
    row(gt, ['namespace', 'connected', 'clients'], 'th');
    for (const g of conns)
      row(gt, [g.namespace, String(g.connectedCount),
               (g.clients || []).join(', ')]);
    if (conns.length) view.appendChild(gt);
    const entries = Object.entries(s.metrics || {});
    if (entries.length){
      const mt2 = document.createElement('table');
      row(mt2, ['flow id', 'pass qps', 'block qps'], 'th');
      for (const [fid, m] of entries)
        row(mt2, [fid, String(m.pass_qps ?? m.passQps ?? ''),
                  String(m.block_qps ?? m.blockQps ?? '')]);
      view.appendChild(mt2);
    }
  }
  for (const c of mon.clients || []){
    const h = document.createElement('h3');
    h.textContent = 'token client ' + c.machine;
    view.appendChild(h);
    const t = document.createElement('table');
    row(t, ['server', 'timeout ms', 'namespace'], 'th');
    row(t, [(c.config.serverHost ?? '') + ':' + (c.config.serverPort ?? ''),
            String(c.config.requestTimeout ?? ''),
            c.config.namespace ?? '']);
    view.appendChild(t);
  }
  if (!(mon.servers || []).length && !(mon.clients || []).length){
    const p = document.createElement('p');
    p.textContent = 'no machines in cluster mode';
    p.className = 'legend';
    view.appendChild(p);
  }
  await renderAssignManage(app, view);
}
// ---- assignment management (cluster_app_assign_manage.js analog) ----
// server groups with their clients, group unassignment back to standalone,
// and a new-group form (pick a server + client set + token port)
async function renderAssignManage(app, view){
  const h = document.createElement('h3');
  h.textContent = 'assignment management';
  view.appendChild(h);
  let st;
  try { st = await api('cluster/assign/state?app='+encodeURIComponent(app)); }
  catch(e){ return; }
  const gt = document.createElement('table');
  row(gt, ['server group', 'token port', 'clients', ''], 'th');
  for (const g of st.servers || []){
    const ub = document.createElement('button');
    ub.textContent = 'unassign group';
    ub.onclick = () => manageAssign(app,
      {unassign: [g.machine, ...g.clients]});
    row(gt, [g.machine, String(g.port), (g.clients || []).join(', '), ub]);
  }
  if ((st.servers || []).length) view.appendChild(gt);
  const pool = [...(st.unassigned || []),
                ...(st.servers || []).flatMap(g => [g.machine, ...g.clients])];
  const form = document.createElement('div');
  const lbl = document.createElement('span');
  lbl.className = 'legend'; lbl.textContent = 'new group: server ';
  form.appendChild(lbl);
  const ssel = document.createElement('select');
  for (const mk of pool){
    const o = document.createElement('option');
    o.value = mk; o.textContent = mk; ssel.appendChild(o);
  }
  form.appendChild(ssel);
  const plbl = document.createElement('span');
  plbl.className = 'legend'; plbl.textContent = ' port ';
  form.appendChild(plbl);
  const port = document.createElement('input');
  port.value = '18730'; port.size = 6; form.appendChild(port);
  const boxes = [];
  for (const mk of pool){
    const cb = document.createElement('input');
    cb.type = 'checkbox'; cb.value = mk; boxes.push(cb);
    const cl = document.createElement('label');
    cl.className = 'legend';
    cl.appendChild(cb); cl.appendChild(document.createTextNode(mk));
    form.appendChild(cl);
  }
  const apply = document.createElement('button');
  apply.textContent = 'assign group';
  apply.onclick = () => manageAssign(app, {groups: [{
    server: ssel.value, tokenPort: +port.value || 18730,
    clients: boxes.filter(b => b.checked && b.value !== ssel.value)
                  .map(b => b.value)}]});
  form.appendChild(apply);
  view.appendChild(form);
  if (st.unknown && st.unknown.length){
    const p = document.createElement('p');
    p.className = 'legend';
    p.textContent = 'unreachable: ' + st.unknown.join(', ');
    view.appendChild(p);
  }
}
async function manageAssign(app, payload){
  const r = await fetch('cluster/assign/manage?app='+encodeURIComponent(app),
    {method:'POST', body: JSON.stringify(payload)});
  alert(JSON.stringify(await r.json()));
  openCluster(app);
}
const MODES = {'-1':'off','0':'client','1':'server'};
// single-flight refresh: overlapping runs (interval + filter keystrokes)
// would interleave their async appends into #apps and duplicate sections
let refreshBusy = false, refreshAgain = false, filterTimer = null;
function filterChanged(){
  // debounce: the filter is client-side, but the repaint walks the full
  // fetch loop — one run per typing pause, not per keystroke
  clearTimeout(filterTimer);
  filterTimer = setTimeout(refresh, 300);
}
async function refresh(){
  if (refreshBusy){ refreshAgain = true; return; }
  refreshBusy = true;
  try { await refreshOnce(); }
  finally {
    refreshBusy = false;
    if (refreshAgain){ refreshAgain = false; refresh(); }
  }
}
async function refreshOnce(){
  let apps;
  try { apps = await api('apps'); } catch(e){ return; }
  // authenticated and serving: reveal the filter control (it starts
  // hidden so the login screen shows no stray live input)
  document.getElementById('resfilterwrap').style.display = '';
  const root = document.getElementById('apps');
  root.innerHTML = '';
  for (const app of apps){
    const h = document.createElement('h2'); h.textContent = app.name;
    const btn = document.createElement('button');
    btn.textContent = 'rules'; btn.style.marginLeft = '1rem';
    btn.onclick = () => openRules(app.name);
    h.appendChild(btn);
    const cbtn2 = document.createElement('button');
    cbtn2.textContent = 'cluster'; cbtn2.style.marginLeft = '.3rem';
    cbtn2.onclick = () => openCluster(app.name);
    h.appendChild(cbtn2); root.appendChild(h);
    let modes = {};
    try {
      for (const s of await api('cluster/state?app='+encodeURIComponent(app.name)))
        modes[s.machine] = s.mode;
    } catch(e){}
    const mt = document.createElement('table');
    row(mt, ['machine', 'version', 'status', 'cluster', ''], 'th');
    for (const m of app.machines){
      const key = `${m.ip}:${m.port}`;
      const abtn = document.createElement('button');
      abtn.textContent = 'make token server';
      abtn.onclick = () => assign(app.name, key);
      const rbtn = document.createElement('button');
      rbtn.textContent = 'resources';
      rbtn.onclick = () => openMachine(app.name, key);
      const cell = document.createElement('span');
      cell.appendChild(rbtn); cell.appendChild(abtn);
      row(mt, [key, m.version,
               {text: m.healthy?'healthy':'dead', cls: m.healthy?'ok':'dead'},
               MODES[String(modes[key])] ?? '?', cell]);
    }
    root.appendChild(mt);
    let res = await api('resources?app='+encodeURIComponent(app.name));
    // client-side substring filter (the reference sidebar's search box);
    // the input lives outside #apps so it survives the 3s re-render
    const f = (document.getElementById('resfilter').value || '').toLowerCase();
    if (f) res = res.filter(r => r.toLowerCase().includes(f));
    const rt = document.createElement('table');
    row(rt, ['resource', 'pass qps', 'block qps', 'rt ms', ''], 'th');
    const now = Date.now();
    for (const r of res){
      const ms = await api(`metric?app=${encodeURIComponent(app.name)}` +
        `&identity=${encodeURIComponent(r)}&startTime=${now-15000}&endTime=${now}`);
      const last = ms[ms.length-1] || {};
      const cbtn = document.createElement('button');
      cbtn.textContent = 'timeline';
      cbtn.onclick = () => openChart(app.name, r);
      row(rt, [r, last.passQps??'', last.blockQps??'', last.rt??'', cbtn]);
    }
    root.appendChild(rt);
  }
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


class DashboardServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        fetch_interval_s: float = 1.0,
        auth: Optional[Tuple[str, str]] = None,
        rule_plugins: Optional[dict] = None,
    ):
        """``auth=(username, password)`` enables login (the reference's
        ``sentinel.dashboard.auth.username/password`` simple auth); default
        is open access, matching the reference's default ``sentinel/sentinel``
        stance for dev use.

        ``rule_plugins`` maps rule type → ``(DynamicRuleProvider,
        DynamicRulePublisher)`` and backs the ``v2/rules`` route
        (FlowControllerV2 analog — see dashboard/dynamic_rules.py): types
        without a plugin fall back to the direct-to-machine Api pair."""
        self.apps = AppManagement()
        self.repository = InMemoryMetricsRepository()
        self.rules = InMemoryRuleRepository()
        self.client = ApiClient()
        self.fetcher = MetricFetcher(
            self.apps, self.repository, self.client, fetch_interval_s
        )
        self.rule_plugins = dict(rule_plugins or {})
        self.auth = auth
        # token → expiry-ms; bounded and TTL'd (an unbounded forever-valid
        # session set would grow with every login and keep stolen cookies
        # alive until restart)
        self._sessions: dict = {}
        # ThreadingHTTPServer handles each request on its own thread — every
        # _sessions access goes through this lock (prune in place, never
        # rebind, so a concurrent logout can't be lost on an old dict)
        self._sessions_lock = threading.Lock()
        self.session_ttl_ms = 24 * 3600 * 1000
        self.max_sessions = 1000
        self._service = HttpService(
            self._respond, host, port, name="sentinel-dashboard"
        )

    @property
    def host(self) -> str:
        return self._service.host

    @property
    def port(self) -> int:
        return self._service.port

    # -- auth ----------------------------------------------------------------
    def _session_of(self, headers) -> Optional[str]:
        cookie = headers.get("Cookie", "") if headers is not None else ""
        now = _clock.now_ms()
        for part in cookie.split(";"):
            k, _, v = part.strip().partition("=")
            if k == "sentinel_session":
                with self._sessions_lock:
                    expiry = self._sessions.get(v)
                    if expiry is not None and expiry > now:
                        return v
                    self._sessions.pop(v, None)  # expired
        return None

    def _login(self, params: dict, body: str):
        data = json.loads(body) if body else dict(params)
        user, password = self.auth
        if not (
            hmac.compare_digest(str(data.get("username", "")), user)
            and hmac.compare_digest(str(data.get("password", "")), password)
        ):
            return (401, json.dumps({"error": "invalid credentials"}),
                    "application/json; charset=utf-8")
        token = secrets.token_urlsafe(24)
        now = _clock.now_ms()
        with self._sessions_lock:
            for t in [t for t, exp in self._sessions.items() if exp <= now]:
                del self._sessions[t]
            while len(self._sessions) >= self.max_sessions:
                self._sessions.pop(next(iter(self._sessions)))  # oldest first
            self._sessions[token] = now + self.session_ttl_ms
        return (
            200,
            json.dumps({"code": 0}),
            "application/json; charset=utf-8",
            {"Set-Cookie":
             f"sentinel_session={token}; HttpOnly; Path=/; SameSite=Lax"},
        )

    # -- request handling ----------------------------------------------------
    def _respond(
        self, method: str, path: str, params: dict, body: str, headers=None
    ) -> Response:
        if self.auth is not None:
            if method == "POST" and path == "auth/login":
                return self._login(params, body)
            if method == "POST" and path == "auth/logout":
                token = self._session_of(headers)
                if token is not None:
                    with self._sessions_lock:
                        self._sessions.pop(token, None)
                return json_response(200, json.dumps({"code": 0}))
            if path not in AUTH_EXEMPT and self._session_of(headers) is None:
                return json_response(401, json.dumps({"error": "login required"}))
        result = self._route(method, path, params, body)
        if result is None:
            return json_response(404, json.dumps({"error": "not found"}))
        if isinstance(result, str):
            return html_response(200, result)
        return json_response(200, json.dumps(result))

    def _route(self, method: str, path: str, params: dict, body: str):
        if method == "POST" and path == "registry/machine":
            data = json.loads(body) if body else dict(params)
            machine = MachineInfo(
                app=str(data.get("app", "")),
                ip=str(data.get("ip", "")),
                port=int(data.get("port", 0)),
                hostname=str(data.get("hostname", "")),
                version=str(data.get("version", "")),
                last_heartbeat_ms=_clock.now_ms(),
            )
            self.apps.register(machine)
            return {"code": 0, "msg": "success"}
        if path == "apps":
            return [
                {
                    "name": app,
                    "machines": [m.to_dict() for m in self.apps.machines(app)],
                }
                for app in self.apps.apps()
            ]
        if path == "resources":
            # app-wide, or one machine's own resource list when
            # ``machine=ip:port`` is given (identity.js analog)
            machine = params.get("machine", "")
            if machine:
                return self.repository.resources_of_machine(
                    params.get("app", ""), machine
                )
            return self.repository.resources_of_app(params.get("app", ""))
        if path == "metric":
            # app-wide merged series, or one machine's own series when
            # ``machine=ip:port`` is given (metric.js drill-down analog)
            machine = params.get("machine", "")
            if machine:
                entries = self.repository.query_machine(
                    params.get("app", ""),
                    machine,
                    params.get("identity", ""),
                    int(params.get("startTime", 0)),
                    int(params.get("endTime", 2**62)),
                )
            else:
                entries = self.repository.query(
                    params.get("app", ""),
                    params.get("identity", ""),
                    int(params.get("startTime", 0)),
                    int(params.get("endTime", 2**62)),
                )
            return [e.to_dict() for e in entries]
        if path == "metric/machines":
            # machines with live data for a resource — populates the
            # drill-down selector
            return self.repository.machines_of_resource(
                params.get("app", ""), params.get("identity", "")
            )
        if path == "rules":
            app = params.get("app", "")
            rule_type = params.get("type", "flow")
            if rule_type not in RULE_TYPES:
                return {"error": f"unknown rule type {rule_type}"}
            machines = self.apps.healthy_machines(app)
            if not machines:
                return {"error": f"no healthy machine for app {app}"}
            if method == "POST":
                try:
                    rules = json.loads(body)
                except (json.JSONDecodeError, TypeError):
                    return {"error": "body is not valid JSON"}
                if not isinstance(rules, list):
                    return {"error": "body must be a JSON array of rules"}
                for i, r in enumerate(rules):
                    bad = validate_rule(rule_type, r)
                    if bad:
                        return {"error": f"rule[{i}]: {bad}"}
                pushed = sum(
                    self.client.push_rules(m, rule_type, rules) for m in machines
                )
                return {"pushed": pushed, "machines": len(machines)}
            return self.client.fetch_rules(machines[0], rule_type)
        if path == "v2/rules":
            # pluggable provider/publisher route (FlowControllerV2.java:63-64
            # analog): GET reads the authoritative list through the type's
            # DynamicRuleProvider, POST validates then hands the WHOLE list
            # to its DynamicRulePublisher — with a store-backed plugin the
            # dashboard never touches the machines; their datasource
            # watchers converge on the store
            app = params.get("app", "")
            rule_type = params.get("type", "flow")
            if rule_type not in RULE_TYPES:
                return {"error": f"unknown rule type {rule_type}"}
            plugin = self.rule_plugins.get(rule_type)
            if plugin is None:
                from sentinel_tpu_torch.dashboard.dynamic_rules import (
                    ApiRuleProvider,
                    ApiRulePublisher,
                )

                plugin = (
                    ApiRuleProvider(self.apps, self.client, rule_type),
                    ApiRulePublisher(self.apps, self.client, rule_type),
                )
                self.rule_plugins[rule_type] = plugin
            provider, publisher = plugin
            if method == "POST":
                try:
                    rules = json.loads(body)
                except (json.JSONDecodeError, TypeError):
                    return {"error": "body is not valid JSON"}
                if not isinstance(rules, list):
                    return {"error": "body must be a JSON array of rules"}
                for i, r in enumerate(rules):
                    bad = validate_rule(rule_type, r)
                    if bad:
                        return {"error": f"rule[{i}]: {bad}"}
                try:
                    publisher.publish(app, rules)
                except Exception as e:
                    return {"error": f"publish failed: {e}"}
                return {"published": len(rules)}
            try:
                rules = provider.get_rules(app)
            except Exception as e:
                return {"error": f"provider failed: {e}"}
            return rules if rules is not None else {
                "error": f"no rules available for app {app}"
            }
        if path == "v1/rules":
            # per-rule-type console view: fetch live, sync ids, return
            # entities (FlowControllerV1.apiQueryMachineRules analog)
            app = params.get("app", "")
            rule_type = params.get("type", "flow")
            if rule_type not in RULE_TYPES:
                return {"error": f"unknown rule type {rule_type}"}
            machines = self.apps.healthy_machines(app)
            if not machines:
                return {"error": f"no healthy machine for app {app}"}
            live = self.client.fetch_rules(machines[0], rule_type)
            if live is None:
                return {"error": "fetch from app failed"}
            return self.rules.sync(app, rule_type, live)
        if path == "v1/rule":
            # single-rule CRUD (apiAddFlowRule / apiUpdateFlowRule /
            # apiDeleteRule): mutate the id-keyed repository, then publish
            # the assembled list to every healthy machine
            app = params.get("app", "")
            rule_type = params.get("type", "flow")
            if rule_type not in RULE_TYPES:
                return {"error": f"unknown rule type {rule_type}"}
            machines = self.apps.healthy_machines(app)
            if not machines:
                return {"error": f"no healthy machine for app {app}"}
            if not self.rules.known(app, rule_type):
                # never synced (fresh dashboard): seed from the live agent
                # first, or this mutation's push would overwrite whatever
                # rules the agent already holds
                live = self.client.fetch_rules(machines[0], rule_type)
                if live is None:
                    return {"error": "fetch from app failed"}
                self.rules.sync(app, rule_type, live)
            if method in ("POST", "PUT"):
                try:
                    rule = json.loads(body)
                except (json.JSONDecodeError, TypeError):
                    return {"error": "body is not valid JSON"}
                # reject malformed rules BEFORE storing/pushing — the
                # reference's checkEntityInternal chains
                # (FlowControllerV1.java:89-134); see dashboard/validation
                bad = validate_rule(rule_type, rule)
                if bad:
                    return {"error": bad}
                rule.pop("id", None)
            if method == "POST":
                rule_id = self.rules.add(app, rule_type, rule)
            elif method == "PUT":
                rule_id = int(params.get("id", 0))
                if not self.rules.update(app, rule_type, rule_id, rule):
                    return {"error": f"no rule with id {rule_id}"}
            elif method == "DELETE":
                rule_id = int(params.get("id", 0))
                if not self.rules.delete(app, rule_type, rule_id):
                    return {"error": f"no rule with id {rule_id}"}
            else:
                return {"error": "POST/PUT/DELETE only"}
            plain = self.rules.plain_rules(app, rule_type)
            pushed = sum(
                self.client.push_rules(m, rule_type, plain) for m in machines
            )
            return {"id": rule_id, "pushed": pushed, "machines": len(machines)}
        if path == "v1/gateway/apis":
            # gateway custom-API group management (GatewayApiController
            # analog): GET lists the live definitions, POST replaces them on
            # every healthy machine
            app = params.get("app", "")
            machines = self.apps.healthy_machines(app)
            if not machines:
                return {"error": f"no healthy machine for app {app}"}
            if method == "POST":
                # validate before fanning out: a malformed body (from a
                # non-UI client) must return a parse error, not one failing
                # HTTP push per machine with pushed:0 and no explanation
                try:
                    defs = json.loads(body)
                except (json.JSONDecodeError, TypeError):
                    return {"error": "body is not valid JSON"}
                if not isinstance(defs, list) or any(
                    not isinstance(d, dict) or "apiName" not in d
                    for d in defs
                ):
                    return {
                        "error": "body must be a list of {apiName, "
                                 "predicateItems} objects"
                    }
                pushed = sum(
                    1 for m in machines
                    if self.client.push_api_definitions(m, body)
                )
                return {"pushed": pushed, "machines": len(machines)}
            result = self.client.fetch_json(
                machines[0], "gateway/getApiDefinitions"
            )
            return result if result is not None else {"error": "fetch failed"}
        if method == "POST" and path == "machine/remove":
            # per-machine deregistration; ip+port name the machine
            removed = self.apps.remove_machine(
                params.get("app", ""), params.get("ip", ""),
                int(params.get("port", 0)),
            )
            return {"code": 0 if removed else 1}
        if method == "POST" and path == "app/remove":
            self.apps.remove_app(params.get("app", ""))
            return {"code": 0}
        if path == "cluster/state":
            # per-machine cluster mode snapshot (ClusterAssignController's
            # read side): -1 off, 0 client, 1 server, null unreachable
            app = params.get("app", "")
            return [
                {
                    "machine": m.key,
                    "ip": m.ip,
                    "port": m.port,
                    "mode": self.client.get_cluster_mode(m),
                }
                for m in self.apps.healthy_machines(app)
            ]
        if path == "cluster/monitor":
            # cluster monitor screen data (cluster_app_server_monitor.js
            # analog): for each server-mode machine the token-server info
            # (port, namespaces, flow config, connection groups) and live
            # per-flow metrics; for each client-mode machine its assignment
            app = params.get("app", "")
            out = {"servers": [], "clients": []}
            for m in self.apps.healthy_machines(app):
                mode = self.client.get_cluster_mode(m)
                if mode == 1:
                    out["servers"].append({
                        "machine": m.key,
                        "info": self.client.fetch_json(
                            m, "cluster/server/info") or {},
                        "metrics": self.client.fetch_json(
                            m, "cluster/server/metrics") or {},
                        # pipeline breakdown: verdict counters by namespace,
                        # stage latency histograms, queue/connection gauges
                        "stats": self.client.fetch_json(
                            m, "clusterServerStats") or {},
                    })
                elif mode == 0:
                    out["clients"].append({
                        "machine": m.key,
                        "config": self.client.fetch_json(
                            m, "cluster/client/fetchConfig") or {},
                    })
            return out
        if method == "POST" and path == "cluster/assign":
            # one-shot assignment (ClusterAssignServiceImpl analog): flip the
            # chosen machine to server mode, everything else to client mode
            # pointed at it — the single-group case of _apply_assign_groups,
            # with this route's historical response shape preserved
            data = json.loads(body) if body else {}
            app = params.get("app", "") or data.get("app", "")
            server_key = data.get("server", "")
            machines = self.apps.healthy_machines(app)
            if not any(m.key == server_key for m in machines):
                return {"error": f"machine {server_key} not found/healthy"}
            res = self._apply_assign_groups(
                machines,
                [{
                    "server": server_key,
                    "tokenPort": data.get("tokenPort", 18730),
                    "clients": [m.key for m in machines
                                if m.key != server_key],
                }],
                (),
            )
            g = res["groups"][0]
            if "error" in g:
                # fail-stop happened inside the group apply: no client of
                # this group was reconfigured; what the machine answered, if
                # it answered, is part of the error
                detail = res.get("errors", {}).get(server_key)
                return {"error": f"promoting {server_key} to token server "
                        "failed; no clients were reconfigured"
                        + (f": {detail}" if detail else "")}
            return {"server": True, "clients": g["clients"],
                    "failed": res["failed"]}
        if path == "cluster/assign/state":
            # live assignment view (cluster_app_assign_manage.js analog):
            # server groups with their pointed-at clients, plus machines in
            # neither role — reconstructed from each machine's own mode and
            # client config, so the view is truth, not dashboard memory
            app = params.get("app", "")
            machines = self.apps.healthy_machines(app)
            by_addr = {}  # "ip:tokenPort" → server group
            state = {"servers": [], "unassigned": [], "unknown": []}
            clients = []
            for m in machines:
                mode = self.client.get_cluster_mode(m)
                if mode == 1:
                    info = self.client.fetch_json(m, "cluster/server/info")
                    if info is None:
                        # a known server whose info fetch failed: transport
                        # trouble, not definitive state — 'unknown', never
                        # 'unassigned' (an operator acting on 'unassigned'
                        # would re-assign a live server)
                        state["unknown"].append(m.key)
                        continue
                    group = {
                        "machine": m.key,
                        "ip": m.ip,
                        "port": int(info.get("port", 0) or 0),
                        "clients": [],
                    }
                    state["servers"].append(group)
                    by_addr[f"{m.ip}:{group['port']}"] = group
                elif mode == 0:
                    clients.append(m)
                elif mode is None:
                    state["unknown"].append(m.key)
                else:
                    state["unassigned"].append(m.key)
            for m in clients:
                cfg = self.client.fetch_json(m, "cluster/client/fetchConfig")
                if cfg is None:
                    # active client, config unreadable right now: transport
                    # failure is 'unknown', not a standalone verdict
                    state["unknown"].append(m.key)
                    continue
                addr = f"{cfg.get('serverHost', '')}:{cfg.get('serverPort', '')}"
                group = by_addr.get(addr)
                if group is not None:
                    group["clients"].append(m.key)
                else:
                    # definitively points at a server outside this app's
                    # healthy set (an orphan client)
                    state["unassigned"].append(m.key)
            return state
        if method == "POST" and path == "cluster/assign/manage":
            # full assignment management (ClusterAssignServiceImpl
            # applyAssignToApp / unbindClusterServers analog): multiple
            # server GROUPS, each with its own client set, plus explicit
            # unassignment back to standalone (mode -1). Per-group
            # fail-stop: a group whose server promotion fails reconfigures
            # none of its clients.
            data = json.loads(body) if body else {}
            app = params.get("app", "") or data.get("app", "")
            return self._apply_assign_groups(
                self.apps.healthy_machines(app),
                data.get("groups", ()),
                data.get("unassign", ()),
            )
        if path in ("", "index.html"):
            return _INDEX_HTML
        return None

    def _apply_assign_groups(self, healthy, groups, unassign) -> dict:
        """Apply server groups + unassignments (the one sequence behind both
        POST cluster/assign and POST cluster/assign/manage). Per-group
        fail-stop: a group whose server promotion fails reconfigures none
        of its clients. A switch a machine answered as failed (its token
        service or door did not come up) is named under ``errors``, by
        machine."""
        machines = {m.key: m for m in healthy}
        results = {"groups": [], "unassigned": 0, "failed": []}
        errors = {}

        def switch(m, mode, token_port=None) -> bool:
            try:
                return self.client.set_cluster_mode(m, mode, token_port)
            except CommandFailed as e:
                errors[m.key] = str(e)
                return False

        for group in groups:
            server_key = group.get("server", "")
            token_port = int(group.get("tokenPort", 18730))
            server = machines.get(server_key)
            gres = {"server": server_key, "clients": 0}
            if server is None or not switch(server, 1, token_port):
                gres["error"] = "server not found/healthy or promote failed"
                results["groups"].append(gres)
                results["failed"].append(server_key)
                continue
            for ckey in group.get("clients", ()):
                m = machines.get(ckey)
                ok = m is not None and self.client.push_cluster_client_config(
                    m, server.ip, token_port
                ) and switch(m, 0)
                if ok:
                    gres["clients"] += 1
                else:
                    results["failed"].append(ckey)
            results["groups"].append(gres)
        for ckey in unassign:
            m = machines.get(ckey)
            # mode -1 = standalone: the agent tears down its token
            # client/server and local checks take over (the unbind path of
            # the reference's assign service)
            if m is not None and switch(m, -1):
                results["unassigned"] += 1
            else:
                results["failed"].append(ckey)
        if errors:
            results["errors"] = errors
        return results

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DashboardServer":
        self._service.start()
        self.fetcher.start()
        return self

    def stop(self) -> None:
        self.fetcher.stop()
        self._service.stop()
