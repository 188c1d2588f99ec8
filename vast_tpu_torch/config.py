"""The task-string grammar, as the port uses it.

Own copy of ``vast_tpu.config.parse_task_string`` (model/vast.py:327-344
of the reference): tasks are ``_``-separated heads, each head
``name%subtask%...`` with subtask in {tv, ta, tva, tvs, tvas}, e.g.
``ret%tva``. The rest of the config system comes with the CLI slice.
"""

from __future__ import annotations

SUBTASKS = ("tv", "ta", "tva", "tvs", "tvas")


def parse_task_string(task: str) -> list[tuple[str, list[str]]]:
    """``'ret%tvas%tv_cap%tvas'`` -> ``[('ret', ['tvas','tv']), ('cap', ['tvas'])]``."""
    heads = []
    for head in task.split("_"):
        parts = head.split("%")
        name, subtasks = parts[0], parts[1:]
        for s in subtasks:
            if s not in SUBTASKS:
                raise ValueError(
                    f"unknown subtask {s!r} in task string {task!r}")
        heads.append((name, subtasks))
    return heads
