"""Kernel-side sanitizer hook registry (host side, zero-cost when off).

The paged kernel wrappers (``ops.arena_decode_attention`` /
``ops.attention_paged``) address arena rows through slot ids and block
tables.  ``notify_rows`` hands those ids to any registered hooks
(``ArenaSanitizer.kernel_hook()`` validates range membership and — when
launches are in flight — registration in an in-flight row set).

No hooks registered (the default) costs one ``if`` per wrapper call and
never copies a device tensor to the host, so the serving path takes no
device->host sync here.  During CUDA graph capture the ids cannot be
read at all and the hooks are skipped.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

Hook = Callable[[str, Any, int], None]      # (where, rows, n_rows)

_hooks: Dict[int, Hook] = {}
_next_id = 0


def add_row_hook(hook: Hook) -> int:
    """Register a hook; returns a handle for :func:`remove_row_hook`."""
    global _next_id
    hid = _next_id
    _next_id += 1
    _hooks[hid] = hook
    return hid


def remove_row_hook(hid: int) -> None:
    _hooks.pop(hid, None)


def clear_row_hooks() -> None:
    _hooks.clear()


def notify_rows(where: str, rows: Any, n_rows: int) -> None:
    """Report arena-row operands to registered hooks.

    ``rows`` may be slot ids [B] or block tables [B, nkv]; ``n_rows``
    is the arena's row count INCLUDING the scratch row convention
    (valid ids lie in ``[0, n_rows]`` with ``n_rows`` = scratch).
    A device tensor is copied to the host only when a hook is registered.
    """
    if not _hooks:
        return
    if isinstance(rows, torch.Tensor):
        if rows.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        rows = rows.cpu().numpy()
    for hook in list(_hooks.values()):
        hook(where, rows, n_rows)
