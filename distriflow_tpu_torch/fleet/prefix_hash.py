"""Port of ``distriflow_tpu/fleet/prefix_hash.py`` (copied with its imports rewritten).

The prompt chain-hash shared by server prefix map and fleet router.

One function, hoisted out of ``server/inference_server.py`` (round 13)
so the router's affinity scoring and the server's ``_prefix_map`` can
never drift: both sides hash a prompt's leading pages with the SAME
chain — ``h_j = sha1(h_{j-1} + tokens[j*ps:(j+1)*ps].tobytes())`` with
``h_{-1} = b""`` — so hash ``j`` covers pages ``0..j`` and a single
lookup proves the whole prefix matches, not just page ``j``.

Shareable pages cap at ``(plen - 1) // page_size``: at least one suffix
token must run through prefill/extend to produce the first-token
logits, so a prompt's final (possibly partial) page is never shared.

``tests/test_fleet_router.py`` pins golden digests for this chain; a
change here is a wire-visible protocol change for every warm cache in
the fleet and must be deliberate.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np


def shareable_pages(plen: int, page_size: int) -> int:
    """How many leading full pages of a ``plen``-token prompt are
    eligible for sharing (the last token always stays private)."""
    return (plen - 1) // page_size


def page_hashes(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Chain hashes of a prompt row's shareable leading pages.

    ``tokens`` is one prompt row; it is coerced to ``int32`` first so
    router and server hash identical bytes regardless of the dtype the
    caller happens to hold (the server's prompts are int32 on the wire).
    """
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    ps = int(page_size)
    hashes: List[bytes] = []
    h = b""
    for j in range(shareable_pages(len(tokens), ps)):
        h = hashlib.sha1(h + tokens[j * ps:(j + 1) * ps].tobytes()).digest()
        hashes.append(h)
    return hashes
