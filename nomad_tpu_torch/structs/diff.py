"""Job diffs for ``nomad plan`` output.

Fills the role of the reference's ``nomad/structs/diff.go`` (Job.Diff):
a structural old-vs-new comparison rendered as nested {Type, Name, Old,
New} records — Type ∈ {None, Added, Deleted, Edited}. Collections of
named objects (task groups, tasks) are matched by name; everything else
diffs field-by-field off the dataclass definition.

Copied from ``nomad_tpu/structs/diff.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# Fields that are server bookkeeping, not part of the user's specification.
_IGNORED_FIELDS = {
    "create_index",
    "modify_index",
    "job_modify_index",
    "alloc_modify_index",
    "version",
    "status",
    "status_description",
    "stable",
    "submit_time",
}

DIFF_NONE = "None"
DIFF_ADDED = "Added"
DIFF_DELETED = "Deleted"
DIFF_EDITED = "Edited"


def _camel(name: str) -> str:
    from ..agent.jsonapi import camel

    return camel(name)


def _render(value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def _field_diffs(old: Any, new: Any, fields) -> List[Dict]:
    out = []
    for f in fields:
        if f.name in _IGNORED_FIELDS:
            continue
        ov = getattr(old, f.name, None) if old is not None else None
        nv = getattr(new, f.name, None) if new is not None else None
        if dataclasses.is_dataclass(ov) or dataclasses.is_dataclass(nv):
            continue  # nested objects handled by object diffs
        if isinstance(ov, (list, dict)) or isinstance(nv, (list, dict)):
            if ov != nv:
                out.append(
                    {
                        "Type": DIFF_EDITED,
                        "Name": _camel(f.name),
                        "Old": _render(ov),
                        "New": _render(nv),
                    }
                )
            continue
        if ov != nv:
            _empty = (None, "", 0, False)
            if old is None or (ov in _empty and nv not in _empty):
                kind = DIFF_ADDED
            elif new is None or (nv in _empty and ov not in _empty):
                kind = DIFF_DELETED
            else:
                kind = DIFF_EDITED
            out.append(
                {
                    "Type": kind,
                    "Name": _camel(f.name),
                    "Old": _render(ov),
                    "New": _render(nv),
                }
            )
    return out


def _object_diff(name: str, old: Any, new: Any) -> Optional[Dict]:
    """Diff two optional dataclass values (update block, periodic, ...)."""
    if old is None and new is None:
        return None
    cls = type(new if new is not None else old)
    fields = dataclasses.fields(cls)
    fdiffs = _field_diffs(old, new, fields)
    if not fdiffs and old is not None and new is not None:
        return None
    kind = DIFF_ADDED if old is None else (DIFF_DELETED if new is None else DIFF_EDITED)
    return {"Type": kind, "Name": name, "Fields": fdiffs}


def _task_diff(old, new) -> Optional[Dict]:
    name = (new or old).name
    fdiffs = _field_diffs(old, new, dataclasses.fields(type(new or old)))
    if old is None:
        return {"Type": DIFF_ADDED, "Name": name, "Fields": fdiffs}
    if new is None:
        return {"Type": DIFF_DELETED, "Name": name, "Fields": fdiffs}
    if not fdiffs:
        return None
    return {"Type": DIFF_EDITED, "Name": name, "Fields": fdiffs}


def _tg_diff(old, new) -> Optional[Dict]:
    name = (new or old).name
    fdiffs = _field_diffs(old, new, dataclasses.fields(type(new or old)))
    task_diffs = _named_list_diffs(
        old.tasks if old else [], new.tasks if new else [], _task_diff
    )
    objs = []
    for attr in ("restart_policy", "reschedule_policy", "update", "migrate_strategy",
                 "ephemeral_disk"):
        d = _object_diff(
            _camel(attr),
            getattr(old, attr, None) if old else None,
            getattr(new, attr, None) if new else None,
        )
        if d is not None:
            objs.append(d)
    if old is None:
        kind = DIFF_ADDED
    elif new is None:
        kind = DIFF_DELETED
    elif fdiffs or task_diffs or objs:
        kind = DIFF_EDITED
    else:
        return None
    return {
        "Type": kind,
        "Name": name,
        "Fields": fdiffs,
        "Objects": objs,
        "Tasks": task_diffs,
    }


def _named_list_diffs(olds: List, news: List, differ) -> List[Dict]:
    by_name_old = {o.name: o for o in olds}
    by_name_new = {n.name: n for n in news}
    out = []
    for name in sorted(set(by_name_old) | set(by_name_new)):
        d = differ(by_name_old.get(name), by_name_new.get(name))
        if d is not None:
            out.append(d)
    return out


def job_diff(old, new) -> Dict:
    """Diff two Jobs; either side may be None (register / stop)."""
    if old is None and new is None:
        return {"Type": DIFF_NONE, "ID": "", "Fields": [], "Objects": [],
                "TaskGroups": []}
    job = new if new is not None else old
    fdiffs = _field_diffs(old, new, dataclasses.fields(type(job)))
    tg_diffs = _named_list_diffs(
        old.task_groups if old else [], new.task_groups if new else [], _tg_diff
    )
    objs = []
    for attr in ("update", "periodic", "parameterized"):
        d = _object_diff(
            _camel(attr),
            getattr(old, attr, None) if old else None,
            getattr(new, attr, None) if new else None,
        )
        if d is not None:
            objs.append(d)
    if old is None:
        kind = DIFF_ADDED
    elif new is None:
        kind = DIFF_DELETED
    elif fdiffs or tg_diffs or objs:
        kind = DIFF_EDITED
    else:
        kind = DIFF_NONE
    return {
        "Type": kind,
        "ID": job.id,
        "Fields": fdiffs,
        "Objects": objs,
        "TaskGroups": tg_diffs,
    }
