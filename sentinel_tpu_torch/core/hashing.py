"""Stable parameter-value hashing (the port's copy of
``sentinel_tpu/core/hashing.py``).

Hot-param values never cross the wire or touch the device — only their
stable 63-bit hash does (``cluster.protocol`` PARAM_FLOW frames, the CMS
kernel's host-side index derivation). Stability across processes matters:
client and server must agree, so Python's salted ``hash()`` is out.
"""

from __future__ import annotations

import hashlib
from typing import Any


def stable_param_hash(value: Any) -> int:
    """Type-tagged so ``1``, ``"1"`` and ``b"1"`` never share a bucket.

    Stability holds for values whose textual form is process-stable (str,
    bytes, numbers, bools, None, and containers thereof). Objects whose
    ``repr`` embeds ``id()`` hash per-instance — pass a stable key (e.g. the
    object's id field) as the parameter instead.

    **Wire contract**: these hashes cross the token-RPC wire (PARAM_FLOW
    requests carry hashes, not values — ``cluster/protocol.py``), so every
    node of a cluster must hash identically. Any change to the tagging or
    digest here is a protocol break and must ship with a wire-protocol
    version bump and a rolling-upgrade note.
    """
    if isinstance(value, bytes):
        tag, data = b"b", value
    elif isinstance(value, str):
        tag, data = b"s", value.encode()
    elif isinstance(value, bool):  # before int: bool is an int subclass
        tag, data = b"B", str(value).encode()
    elif isinstance(value, int):
        tag, data = b"i", str(value).encode()
    elif isinstance(value, float):
        tag, data = b"f", repr(value).encode()
    elif value is None:
        tag, data = b"n", b""
    else:
        tag, data = b"r", repr(value).encode()
    return int.from_bytes(
        hashlib.blake2b(tag + b"\x00" + data, digest_size=8).digest(), "big"
    ) & ((1 << 63) - 1)
