"""Built-in web UI served at /ui.

Fills the role of the reference's Ember SPA (``ui/``, served by the agent
at http.go:213) with a no-build-step single-file app over the same /v1
JSON API: jobs (list/detail/stop), allocations (task states, events, log
viewer via the fs API), nodes (attributes, drain/eligibility), evals,
deployments (promote/fail), and servers (members, raft config, autopilot
health). ACL token entry is stored in localStorage and sent as
X-Nomad-Token, like the reference UI's token page.

Copied from ``nomad_tpu/agent/ui.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

UI_HTML = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Nomad-TPU</title>
<style>
:root{--bg:#f7f8fa;--panel:#fff;--ink:#1f2430;--mut:#68707f;--line:#e3e6eb;
--brand:#16a394;--bad:#c4442e;--warn:#b98a00;--ok:#2f855a;--mono:ui-monospace,Menlo,monospace}
*{box-sizing:border-box}body{margin:0;font:14px/1.45 system-ui,sans-serif;
background:var(--bg);color:var(--ink)}
header{display:flex;align-items:center;gap:18px;background:var(--panel);
border-bottom:1px solid var(--line);padding:10px 20px;position:sticky;top:0}
header b{color:var(--brand);font-size:16px}
nav a{color:var(--mut);text-decoration:none;margin-right:14px;padding:4px 2px}
nav a.on{color:var(--ink);border-bottom:2px solid var(--brand)}
#token{margin-left:auto;font:12px var(--mono);width:200px;padding:4px 6px;
border:1px solid var(--line);border-radius:4px}
main{max-width:1100px;margin:18px auto;padding:0 16px}
table{width:100%;border-collapse:collapse;background:var(--panel);
border:1px solid var(--line);border-radius:6px;overflow:hidden}
th,td{text-align:left;padding:8px 12px;border-bottom:1px solid var(--line)}
th{font-size:12px;text-transform:uppercase;letter-spacing:.04em;color:var(--mut)}
tr:last-child td{border-bottom:0}
tbody tr:hover{background:#f0f4f8;cursor:pointer}
.tag{display:inline-block;padding:1px 8px;border-radius:10px;font-size:12px}
.t-running,.t-ready,.t-complete,.t-successful,.t-alive{background:#e3f5ec;color:var(--ok)}
.t-pending,.t-paused{background:#fdf3d7;color:var(--warn)}
.t-failed,.t-dead,.t-down,.t-lost{background:#fbe6e0;color:var(--bad)}
.t-blocked,.t-other{background:#e8eaf0;color:var(--mut)}
h2{margin:18px 0 10px}h3{margin:16px 0 8px}
.kv{display:grid;grid-template-columns:220px 1fr;gap:4px 14px;background:var(--panel);
border:1px solid var(--line);border-radius:6px;padding:12px}
.kv div:nth-child(odd){color:var(--mut)}
pre{background:#101418;color:#d6dde6;padding:12px;border-radius:6px;
overflow:auto;font:12px/1.5 var(--mono);max-height:420px;white-space:pre-wrap}
button{background:var(--brand);color:#fff;border:0;border-radius:4px;
padding:6px 12px;cursor:pointer;margin-right:8px}
button.risk{background:var(--bad)}
.crumb{color:var(--mut);margin-bottom:6px}.crumb a{color:var(--brand)}
.err{background:#fbe6e0;color:var(--bad);padding:10px;border-radius:6px;margin:10px 0}
.mut{color:var(--mut)}
.meters{display:grid;grid-template-columns:repeat(auto-fill,minmax(240px,1fr));
gap:10px;margin:8px 0}
.meter{background:var(--panel);border:1px solid var(--line);border-radius:6px;
padding:10px 12px}
.meter .lbl{font-size:12px;color:var(--mut);margin-bottom:4px}
.meter .val{font:600 14px/1.2 system-ui;color:var(--ink);margin-bottom:6px}
.meter .bar{height:6px;background:var(--line);border-radius:3px;overflow:hidden}
.meter .bar i{display:block;height:100%;background:var(--brand);border-radius:3px}
.meter .spark{display:block;margin-top:6px;color:var(--brand);width:100%}
.topo{display:grid;grid-template-columns:repeat(auto-fill,minmax(210px,1fr));gap:8px}
.topo-node{background:var(--panel);border:1px solid var(--line);border-radius:6px;
  padding:8px;cursor:pointer}
.topo-node .bar{height:5px;background:var(--line);border-radius:3px;
  overflow:hidden;margin-top:6px}
.topo-node .bar i{display:block;height:100%;background:var(--brand)}
.topo-node .chips{margin-top:6px;line-height:14px}
.chip{display:inline-block;width:10px;height:10px;border-radius:2px;
  margin:0 2px 2px 0;cursor:pointer}
button.act{padding:2px 8px;font-size:12px;margin-right:4px}
button.act.warn{background:var(--bad)}
.logbar{display:flex;gap:8px;align-items:center;margin:8px 0}
.logbar select,.logbar input[type=text]{font:12px var(--mono);padding:4px 6px;
border:1px solid var(--line);border-radius:4px}
.term{background:#101418;color:#d6dde6;padding:12px;border-radius:6px;
overflow:auto;font:12px/1.5 var(--mono);height:260px;white-space:pre-wrap}
.termin{width:100%;font:12px var(--mono);padding:6px 8px;margin-top:6px;
border:1px solid var(--line);border-radius:4px;background:#101418;color:#d6dde6}
</style>
</head>
<body>
<header>
  <b>nomad-tpu</b>
  <nav id="nav"></nav>
  <input id="token" placeholder="ACL token" title="X-Nomad-Token">
</header>
<main id="main">loading…</main>
<script>
"use strict";
const $ = s => document.querySelector(s);
const NAV = [["jobs","Jobs"],["run","Run Job"],["nodes","Nodes"],
             ["topo","Topology"],["allocs","Allocations"],
             ["evals","Evaluations"],["deploys","Deployments"],
             ["servers","Servers"]];
const tokenBox = $("#token");
tokenBox.value = localStorage.getItem("nomad_token") || "";
tokenBox.onchange = () => { localStorage.setItem("nomad_token", tokenBox.value); render(); };

async function api(path, opts) {
  const headers = {};
  const tok = localStorage.getItem("nomad_token");
  if (tok) headers["X-Nomad-Token"] = tok;
  // merge caller headers INTO the token headers — Object.assign at the
  // top level would replace the headers object and drop the token
  opts = opts || {};
  const merged = Object.assign({}, headers, opts.headers || {});
  const r = await fetch(path, Object.assign({}, opts, {headers: merged}));
  if (!r.ok) throw new Error(r.status + " " + await r.text());
  const ct = r.headers.get("Content-Type") || "";
  return ct.includes("json") ? r.json() : r.text();
}
const esc = s => String(s ?? "").replace(/[&<>"'`]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;","`":"&#96;"}[c]));
const tag = s => { const k = String(s||"other").toLowerCase();
  const known = ["running","ready","complete","successful","alive","pending",
                 "paused","failed","dead","down","lost","blocked"];
  return `<span class="tag t-${known.includes(k)?k:"other"}">${esc(s)}</span>`; };
const short = id => esc(String(id||"").slice(0,8));
const when = ns => ns ? new Date(ns/1e6).toLocaleString() : "";
function table(headers, rows, onclickPrefix) {
  const h = headers.map(x=>`<th>${x}</th>`).join("");
  const b = rows.map(r => {
    // navigation via a data attribute + delegated listener: IDs are
    // user-controlled and must never be spliced into inline JS
    const link = onclickPrefix && r.__id ?
      ` data-href="${esc(onclickPrefix + "/" + encodeURIComponent(r.__id))}"` : "";
    return `<tr${link}>` + r.cells.map(c=>`<td>${c}</td>`).join("") + "</tr>";
  }).join("");
  return `<table><thead><tr>${h}</tr></thead><tbody>${b || ""}</tbody></table>`
    + (rows.length ? "" : `<p class="mut">none</p>`);
}
document.addEventListener("click", e => {
  // rows, topology cards and alloc chips all navigate the same way;
  // closest() picks the innermost target (chip inside a node card)
  const el = e.target.closest("[data-href]");
  if (el) location.hash = el.dataset.href;
});

const pages = {
  // job submit/edit: HCL in, parse -> plan preview -> register
  // (the Ember app's job-run flow; /v1/jobs/parse + /v1/job/<id>/plan)
  async run(id) {
    let seed = "";
    if (id) {
      try {
        const j = await api("/v1/job/" + encodeURIComponent(id));
        seed = JSON.stringify(j, null, 2);
      } catch (e) { seed = ""; }
    }
    const html = `<h2>${id ? "Edit Job" : "Run Job"}</h2>
      <p class="mut">Paste an HCL jobspec (or JSON when editing); Plan
      previews the scheduler diff without committing, Run registers.</p>
      <textarea id="jobspec" class="termin" style="height:260px"
        placeholder='job "example" { ... }'>${esc(seed)}</textarea>
      <p style="margin-top:8px">
        <button id="plan-btn">Plan</button>
        <button id="run-btn">Run</button></p>
      <div id="run-out"></div>`;
    return {html, after: () => {
      const out = $("#run-out");
      async function parsed() {
        const src = $("#jobspec").value;
        const trimmed = src.trim();
        if (trimmed.startsWith("{")) {
          const j = JSON.parse(trimmed);
          return j.Job || j;
        }
        return api("/v1/jobs/parse", {method: "POST",
          headers: {"Content-Type": "application/json"},
          body: JSON.stringify({JobHCL: src})});
      }
      $("#plan-btn").addEventListener("click", async () => {
        try {
          const job = await parsed();
          const plan = await api("/v1/job/" + encodeURIComponent(job.ID) + "/plan",
            {method: "PUT", headers: {"Content-Type": "application/json"},
             body: JSON.stringify({Job: job, Diff: true})});
          out.innerHTML = `<h3>Plan</h3><pre>${esc(JSON.stringify(plan, null, 2))}</pre>`;
        } catch (e) { out.innerHTML = `<div class="err">${esc(e.message)}</div>`; }
      });
      $("#run-btn").addEventListener("click", async () => {
        try {
          const job = await parsed();
          await api("/v1/jobs", {method: "POST",
            headers: {"Content-Type": "application/json"},
            body: JSON.stringify({Job: job})});
          location.hash = "#/jobs/" + encodeURIComponent(job.ID);
        } catch (e) { out.innerHTML = `<div class="err">${esc(e.message)}</div>`; }
      });
    }};
  },
  async jobs() {
    const jobs = await api("/v1/jobs");
    return `<h2>Jobs <a href="#/run" style="float:right;font-size:14px">+ Run Job</a></h2>` + table(
      ["ID","Type","Priority","Status","Groups"],
      jobs.map(j => ({__id: j.ID, cells: [
        esc(j.ID), esc(j.Type), j.Priority, tag(j.Status),
        Object.keys(j.JobSummary?.Summary || {}).length]})),
      "#/jobs");
  },
  async job(id) {
    const j = await api("/v1/job/" + encodeURIComponent(id));
    const allocs = await api(`/v1/job/${encodeURIComponent(id)}/allocations?all=true`);
    const evals = await api(`/v1/job/${encodeURIComponent(id)}/evaluations`);
    return `<div class="crumb"><a href="#/jobs">jobs</a> / ${esc(id)}</div>
      <h2>${esc(j.Name || id)} ${tag(j.Status)}</h2>
      <p><button class="risk" data-stop-job="${esc(id)}">Stop job</button>
         <a href="#/run/${encodeURIComponent(id)}"><button>Edit job</button></a></p>
      <div class="kv"><div>Type</div><div>${esc(j.Type)}</div>
        <div>Priority</div><div>${j.Priority}</div>
        <div>Datacenters</div><div>${esc((j.Datacenters||[]).join(", "))}</div>
        <div>Version</div><div>${j.Version ?? 0}</div></div>
      <h3>Allocations</h3>` + table(
        ["ID","Group","Desired","Client status","Node"],
        (allocs||[]).map(a => ({__id: a.ID, cells: [
          short(a.ID), esc(a.TaskGroup), esc(a.DesiredStatus),
          tag(a.ClientStatus), short(a.NodeID)]})), "#/allocs")
      + `<h3>Evaluations</h3>` + table(
        ["ID","Triggered by","Status"],
        (evals||[]).map(e => ({cells: [short(e.ID), esc(e.TriggeredBy),
                                       tag(e.Status)]})));
  },
  async allocs() {
    const allocs = await api("/v1/allocations");
    return `<h2>Allocations</h2>` + table(
      ["ID","Job","Group","Desired","Client status","Modified"],
      allocs.map(a => ({__id: a.ID, cells: [
        short(a.ID), esc(a.JobID), esc(a.TaskGroup), esc(a.DesiredStatus),
        tag(a.ClientStatus), when(a.ModifyTime)]})), "#/allocs");
  },
  async alloc(id) {
    const a = await api("/v1/allocation/" + encodeURIComponent(id));
    const states = a.TaskStates || {};
    const tasks = Object.keys(states);
    const opts = tasks.map(t => `<option>${esc(t)}</option>`).join("");
    const html = `<div class="crumb"><a href="#/allocs">allocations</a> / ${short(id)}</div>
      <h2>${esc(a.Name || id)} ${tag(a.ClientStatus)}</h2>
      <div class="kv"><div>Job</div><div><a href="#/jobs/${esc(a.JobID)}">${esc(a.JobID)}</a></div>
        <div>Node</div><div><a href="#/nodes/${esc(a.NodeID)}">${short(a.NodeID)}</a></div>
        <div>Desired</div><div>${esc(a.DesiredStatus)}</div>
        <div>Previous alloc</div><div>${short(a.PreviousAllocation) || "—"}</div></div>
      <h3>Resource usage</h3><div class="meters" id="meters">
        <div class="meter"><div class="lbl">loading…</div></div></div>
      ${tasks.map(t => `<h3>Task ${esc(t)} ${tag(states[t].State)}</h3>` + table(
        ["Time","Type","Message"],
        (states[t].Events||[]).map(e => ({cells: [
          when(e.Time), esc(e.Type), esc(e.DisplayMessage || e.Message || "")]}))
      )).join("")}
      <h3>Logs</h3>
      <div class="logbar">
        <select id="log-task">${opts}</select>
        <select id="log-type"><option>stdout</option><option>stderr</option></select>
        <label><input type="checkbox" id="log-follow" checked> follow</label>
      </div>
      <pre id="log-view">(loading…)</pre>
      <h3>Exec</h3>
      <div class="logbar">
        <select id="exec-task">${opts}</select>
        <input type="text" id="exec-cmd" size="40" value="/bin/sh" title="command">
        <button id="exec-run">Run</button>
        <button id="exec-stop" class="risk" disabled>Stop</button>
      </div>
      <div class="term" id="term">(no session — Run starts an interactive
websocket exec against the task)</div>
      <input class="termin" id="term-in" placeholder="stdin — Enter sends a line" disabled>`;
    // the hook travels WITH the page result, so a stale fetch that lost
    // the navigation race can never install its wiring on another page
    return {html, after: () => wireAllocExtras(id, tasks)};
  },
  async nodes() {
    const nodes = await api("/v1/nodes");
    return `<h2>Nodes</h2>` + table(
      ["ID","Name","DC","Class","Eligibility","Status"],
      nodes.map(n => ({__id: n.ID, cells: [
        short(n.ID), esc(n.Name), esc(n.Datacenter), esc(n.NodeClass||"—"),
        esc(n.SchedulingEligibility), tag(n.Status)]})), "#/nodes");
  },
  async node(id) {
    const n = await api("/v1/node/" + encodeURIComponent(id));
    const allocs = await api(`/v1/node/${encodeURIComponent(id)}/allocations`);
    const attrs = Object.entries(n.Attributes || {}).sort();
    return `<div class="crumb"><a href="#/nodes">nodes</a> / ${short(id)}</div>
      <h2>${esc(n.Name)} ${tag(n.Status)}</h2>
      <div class="kv"><div>Datacenter</div><div>${esc(n.Datacenter)}</div>
        <div>Class</div><div>${esc(n.NodeClass)||"—"}</div>
        <div>Drain</div><div>${n.Drain ? "yes" : "no"}</div>
        <div>Eligibility</div><div>${esc(n.SchedulingEligibility)}</div>
        <div>HTTP</div><div>${esc(n.HTTPAddr||"")}</div></div>
      <h3>Allocations</h3>` + table(
        ["ID","Job","Client status"],
        (allocs||[]).map(a => ({__id: a.ID, cells: [
          short(a.ID), esc(a.JobID), tag(a.ClientStatus)]})), "#/allocs")
      + `<h3>Attributes</h3>` + table(["Key","Value"],
        attrs.map(([k,v]) => ({cells: [esc(k), esc(v)]})));
  },
  async evals() {
    const evals = await api("/v1/evaluations");
    return `<h2>Evaluations</h2>` + table(
      ["ID","Job","Type","Triggered by","Status"],
      evals.map(e => ({cells: [short(e.ID), esc(e.JobID), esc(e.Type),
                               esc(e.TriggeredBy), tag(e.Status)]})));
  },
  async deploys() {
    const ds = await api("/v1/deployments");
    // promote/fail actions on ACTIVE deployments (the Ember app's
    // deployment controls; reference ui/app deployments route). Promote
    // only renders when a group actually has unpromoted canaries — the
    // server rejects promoting anything else.
    const act = d => {
      if (!["running","paused"].includes(d.Status)) return "";
      const canPromote = Object.values(d.TaskGroups || {}).some(
        s => (s.DesiredCanaries || 0) > 0 && !s.Promoted);
      return (canPromote
        ? `<button class="act" data-dep-promote="${esc(d.ID)}">promote</button>`
        : "") +
        `<button class="act warn" data-dep-fail="${esc(d.ID)}">fail</button>`;
    };
    const tgRow = d => Object.entries(d.TaskGroups || {}).map(([g, s]) =>
      `${esc(g)}: ${s.PlacedAllocs||0}/${s.DesiredTotal||0} placed, ` +
      `${s.HealthyAllocs||0} healthy` + (s.Promoted ? ", promoted" : "")
    ).join("<br>");
    return `<h2>Deployments</h2>` + table(
      ["ID","Job","Status","Groups","Description","Actions"],
      ds.map(d => ({cells: [short(d.ID), esc(d.JobID), tag(d.Status),
                            tgRow(d), esc(d.StatusDescription), act(d)]})));
  },
  async topo() {
    // Cluster topology (the Ember app's topology viz, ui/app topology
    // route): one card per node, reserved-capacity fill bars for cpu
    // and memory from the scheduler's view of non-terminal allocs,
    // colored chips per alloc linking to the alloc page.
    const [nodes, stubs] = await Promise.all([
      api("/v1/nodes"), api("/v1/allocations"),
    ]);
    const live = stubs.filter(a => a.DesiredStatus === "run"
      && !["complete","failed","lost"].includes(a.ClientStatus));
    // list entries are slim stubs (the reference's AllocListStub):
    // resources come from the detail endpoint, fetched concurrently
    // and capped so a C1M-scale cluster doesn't stampede the agent
    const CAP = 500;
    const detailed = await Promise.all(live.slice(0, CAP).map(a =>
      api("/v1/allocation/" + encodeURIComponent(a.ID)).catch(() => a)));
    const byNode = {};
    for (const a of detailed) {
      (byNode[a.NodeID] = byNode[a.NodeID] || []).push(a);
    }
    const infos = await Promise.all(nodes.map(n =>
      api("/v1/node/" + encodeURIComponent(n.ID)).catch(() => null)));
    const hue = s => { let h = 0;
      for (const c of String(s)) h = (h * 31 + c.charCodeAt(0)) % 360;
      return h; };
    const cards = nodes.map((n, i) => {
      const info = infos[i] || {};
      const res = info.NodeResources || {};
      const cpuCap = res.CPUShares || 0, memCap = res.MemoryMB || 0;
      const mine = byNode[n.ID] || [];
      let cpu = 0, mem = 0;
      for (const a of mine) {
        const ar = a.AllocatedResources || {};
        for (const t of Object.values(ar.Tasks || {})) {
          cpu += t.CPUShares || 0; mem += t.MemoryMB || 0;
        }
      }
      const pct = (v, cap) => cap ? Math.min(100, 100 * v / cap) : 0;
      const chips = mine.slice(0, 64).map(a =>
        `<i class="chip" data-href="#/allocs/${encodeURIComponent(a.ID)}"
            title="${esc(a.JobID)} · ${esc(a.TaskGroup)}"
            style="background:hsl(${hue(a.JobID)},55%,45%)"></i>`).join("")
        + (mine.length > 64 ? `<span class="mut">+${mine.length - 64}</span>` : "");
      return `<div class="topo-node" data-href="#/nodes/${encodeURIComponent(n.ID)}">
        <div class="lbl">${esc(n.Name)} ${tag(n.Status)}
          <span class="mut">${mine.length} allocs</span></div>
        <div class="bar"><i style="width:${pct(cpu, cpuCap).toFixed(1)}%"></i></div>
        <div class="mut" style="font-size:11px">cpu ${cpu}/${cpuCap} MHz</div>
        <div class="bar"><i style="width:${pct(mem, memCap).toFixed(1)}%"></i></div>
        <div class="mut" style="font-size:11px">mem ${mem}/${memCap} MiB</div>
        <div class="chips">${chips}</div>
      </div>`;
    }).join("");
    const capNote = live.length > CAP
      ? ` (cards sample the first ${CAP} — counts, bars and chips all
         reflect the sample, not the full cluster)` : "";
    return `<h2>Topology</h2>
      <p class="mut">${nodes.length} nodes · ${live.length} scheduled
      allocations${capNote} · chip color = job</p>
      <div class="topo">${cards || '<p class="mut">no nodes</p>'}</div>`;
  },
  async servers() {
    const members = await api("/v1/agent/members");
    const ms = members.Members || members;
    let raft = {Servers: []}, health = null;
    try { raft = await api("/v1/operator/raft/configuration"); } catch (e) {}
    try { health = await api("/v1/operator/autopilot/health"); } catch (e) {}
    return `<h2>Server members</h2>` + table(
      ["Name","Address","Status","Leader","Region"],
      ms.map(m => ({cells: [esc(m.Name), esc(m.Addr)+":"+m.Port, tag(m.Status),
                            m.Leader ? "yes" : "", esc(m.Tags?.region||"")]})))
      + `<h3>Raft configuration</h3>` + table(
        ["ID","Address","Leader","Voter"],
        (raft.Servers||[]).map(s => ({cells: [esc(s.ID), esc(s.Address),
          s.Leader ? "yes" : "", s.Voter ? "yes" : ""]})))
      + (health ? `<h3>Autopilot ${health.Healthy ? tag("ready") : tag("failed")}</h3>`
        + table(["Server","Serf","Healthy","Last index"],
          (health.Servers||[]).map(s => ({cells: [esc(s.Name), esc(s.SerfStatus),
            s.Healthy ? tag("ready") : tag("failed"), s.LastIndex]}))) : "");
  },
};

async function stopJob(id) {
  if (!confirm("Stop job " + id + "?")) return;
  try { await api("/v1/job/" + encodeURIComponent(id), {method: "DELETE"}); }
  catch (e) { alert(e.message); }
  render();
}
document.addEventListener("click", e => {
  const btn = e.target.closest("[data-stop-job]");
  if (btn) stopJob(btn.dataset.stopJob);
});

async function deploymentAction(id, action) {
  if (!confirm(action + " deployment " + id.slice(0, 8) + "?")) return;
  try {
    const body = action === "promote" ? {All: true} : {};
    await api(`/v1/deployment/${action}/${encodeURIComponent(id)}`,
              {method: "PUT", body: JSON.stringify(body),
               headers: {"Content-Type": "application/json"}});
  } catch (e) { alert(e.message); }
  render();
}
document.addEventListener("click", e => {
  const p = e.target.closest("[data-dep-promote]");
  if (p) { deploymentAction(p.dataset.depPromote, "promote"); return; }
  const f = e.target.closest("[data-dep-fail]");
  if (f) deploymentAction(f.dataset.depFail, "fail");
});

// -- alloc-page live extras: meters, server-push logs, exec terminal -----
let pageCleanup = null;     // torn down on navigation (streams, sockets)
const b64encode = s => btoa(String.fromCharCode(...new TextEncoder().encode(s)));
const b64decode = b => new TextDecoder().decode(
  Uint8Array.from(atob(b), c => c.charCodeAt(0)));

function meter(label, pct, detail, sparkSvg) {
  const w = Math.max(0, Math.min(100, pct || 0));
  return `<div class="meter"><div class="lbl">${esc(label)}</div>` +
    `<div class="val">${esc(detail)}</div>` +
    `<div class="bar"><i style="width:${w.toFixed(1)}%"></i></div>` +
    (sparkSvg || "") + `</div>`;
}

// Inline SVG sparkline over a rolling sample window (the Ember app's
// primary-metric charts; reference ui/app stats time-series). Points
// scale to the window max so spikes stay visible.
function spark(points) {
  if (!points || points.length < 2) return "";
  const W = 220, H = 36, n = points.length;
  const max = Math.max(...points, 1e-9);
  const xy = points.map((v, i) => {
    const x = (i / (n - 1)) * (W - 2) + 1;
    const y = H - 2 - (Math.max(0, v) / max) * (H - 6);
    return x.toFixed(1) + "," + y.toFixed(1);
  });
  return `<svg class="spark" viewBox="0 0 ${W} ${H}" width="${W}" height="${H}"` +
    ` preserveAspectRatio="none"><polyline points="${xy.join(" ")}"` +
    ` fill="none" stroke="currentColor" stroke-width="1.5"/></svg>`;
}

const SPARK_WINDOW = 40;  // ~2 minutes at the 3s refresh

function wireAllocExtras(id, tasks) {
  const cleanups = [];
  pageCleanup = () => cleanups.forEach(fn => { try { fn(); } catch (e) {} });

  // utilization meters + live sparklines: a rolling per-task history of
  // cpu% and RSS sampled from /v1/client/allocation/<id>/stats
  const history = {};  // task -> {cpu: [], mem: []}
  async function refreshMeters() {
    try {
      const s = await api(`/v1/client/allocation/${encodeURIComponent(id)}/stats`);
      const parts = [];
      for (const [t, ts] of Object.entries(s.Tasks || {})) {
        const cpu = ts.ResourceUsage?.CpuStats?.Percent || 0;
        const rssMib = (ts.ResourceUsage?.MemoryStats?.RSS || 0) / 1048576;
        const h = history[t] = history[t] || {cpu: [], mem: []};
        h.cpu.push(cpu); h.mem.push(rssMib);
        if (h.cpu.length > SPARK_WINDOW) { h.cpu.shift(); h.mem.shift(); }
        parts.push(meter(`${t} · CPU`, cpu, cpu.toFixed(1) + " %", spark(h.cpu)));
        parts.push(meter(`${t} · memory`, 0, rssMib.toFixed(1) + " MiB", spark(h.mem)));
      }
      if (parts.length) $("#meters").innerHTML = parts.join("");
      else $("#meters").innerHTML = `<div class="meter"><div class="lbl">no running tasks</div></div>`;
    } catch (e) {
      $("#meters").innerHTML = `<div class="meter"><div class="lbl">stats unavailable</div><div class="val mut">${esc(e.message)}</div></div>`;
    }
  }
  refreshMeters();
  const mt = setInterval(refreshMeters, 3000);
  cleanups.push(() => clearInterval(mt));

  // logs: server-push follow stream (fetch + ReadableStream) or one-shot
  let logAbort = null;
  async function startLogs() {
    if (logAbort) { logAbort.abort(); logAbort = null; }
    const t = $("#log-task").value, kind = $("#log-type").value;
    const follow = $("#log-follow").checked;
    const view = $("#log-view");
    view.textContent = "";
    const tok = localStorage.getItem("nomad_token");
    const headers = tok ? {"X-Nomad-Token": tok} : {};
    const url = `/v1/client/fs/logs/${encodeURIComponent(id)}?task=` +
      `${encodeURIComponent(t)}&type=${kind}` + (follow ? "&follow=true&origin=end&offset=4096" : "");
    const ctl = new AbortController();
    logAbort = ctl;
    cleanups.push(() => ctl.abort());
    try {
      const r = await fetch(url, {headers, signal: ctl.signal});
      if (!r.ok) { view.textContent = "(logs unavailable: " + r.status + ")"; return; }
      const reader = r.body.getReader();
      const dec = new TextDecoder();
      for (;;) {
        const {done, value} = await reader.read();
        if (done) break;
        view.textContent += dec.decode(value, {stream: true});
        if (view.textContent.length > 200000)
          view.textContent = view.textContent.slice(-150000);
        view.scrollTop = view.scrollHeight;
      }
    } catch (e) { /* aborted on navigation / toggle */ }
  }
  ["log-task","log-type","log-follow"].forEach(x =>
    $("#"+x).addEventListener("change", startLogs));
  startLogs();

  // exec: interactive websocket terminal (the agent's RFC6455 endpoint)
  let sock = null;
  function execStop() {
    if (sock) { try { sock.close(); } catch (e) {} sock = null; }
    $("#exec-run").disabled = false;
    $("#exec-stop").disabled = true;
    $("#term-in").disabled = true;
  }
  cleanups.push(execStop);
  $("#exec-run").addEventListener("click", () => {
    execStop();
    const t = $("#exec-task").value;
    const cmd = $("#exec-cmd").value.trim();
    if (!cmd) return;
    const term = $("#term");
    term.textContent = "$ " + cmd + "\n";
    const proto = location.protocol === "https:" ? "wss" : "ws";
    // browsers cannot set headers on WebSockets: the ACL token rides the
    // token query param the agent accepts alongside X-Nomad-Token
    const tok = localStorage.getItem("nomad_token");
    const url = `${proto}://${location.host}/v1/client/allocation/` +
      `${encodeURIComponent(id)}/exec?task=${encodeURIComponent(t)}` +
      `&command=${encodeURIComponent(JSON.stringify(cmd.split(/\s+/)))}` +
      (tok ? `&token=${encodeURIComponent(tok)}` : "");
    sock = new WebSocket(url);
    sock.onopen = () => {
      $("#exec-run").disabled = true;
      $("#exec-stop").disabled = false;
      const inp = $("#term-in");
      inp.disabled = false; inp.focus();
    };
    sock.onmessage = ev => {
      try {
        const frame = JSON.parse(ev.data);
        if (frame.stdout?.data) {
          term.textContent += b64decode(frame.stdout.data);
          term.scrollTop = term.scrollHeight;
        }
        if ("exit_code" in frame) {
          term.textContent += `\n(exit ${frame.exit_code})\n`;
          execStop();
        }
      } catch (e) {}
    };
    sock.onclose = execStop;
    sock.onerror = execStop;
  });
  $("#exec-stop").addEventListener("click", () => {
    if (sock) sock.send(JSON.stringify({stdin: {close: true}}));
    execStop();
  });
  $("#term-in").addEventListener("keydown", ev => {
    if (ev.key !== "Enter" || !sock) return;
    const line = ev.target.value + "\n";
    ev.target.value = "";
    $("#term").textContent += line;
    sock.send(JSON.stringify({stdin: {data: b64encode(line)}}));
  });
}

let timer = null;
let renderSeq = 0;
async function render() {
  const seq = ++renderSeq;  // stale async completions must not clobber
  if (pageCleanup) { pageCleanup(); pageCleanup = null; }
  const hash = location.hash.replace(/^#\//, "") || "jobs";
  const [page, id] = hash.split("/");
  $("#nav").innerHTML = NAV.map(([k, label]) =>
    `<a href="#/${k}" class="${page===k?"on":""}">${label}</a>`).join("");
  const fn = id && pages[page.replace(/s$/, "")] ? pages[page.replace(/s$/, "")]
           : pages[page] || pages.jobs;
  let result;
  try {
    result = await fn(id ? decodeURIComponent(id) : undefined);
  } catch (e) {
    result = `<div class="err">${esc(e.message)}</div>`;
  }
  if (seq !== renderSeq) return;  // navigation happened mid-fetch
  const html = typeof result === "string" ? result : result.html;
  $("#main").innerHTML = html;
  if (typeof result === "object" && result.after) result.after();
  clearTimeout(timer);
  // auto-refresh list pages — never the Run Job editor, which would
  // wipe the jobspec being typed
  if (!id && page !== "run") timer = setTimeout(render, 4000);
}
window.addEventListener("hashchange", render);
render();
</script>
</body>
</html>
"""


def register_ui(mux, agent) -> None:
    """Serve the SPA at /ui — http.go:213's slot. (No catch-all "/"
    route: the mux treats trailing-slash prefixes as wildcards, and the
    UI must not shadow unknown /v1 paths' 404s.)"""

    def serve(req):
        req.response_content_type = "text/html; charset=utf-8"
        return UI_HTML.encode()

    mux.register("/ui", serve)
    mux.register("/ui/", serve)
