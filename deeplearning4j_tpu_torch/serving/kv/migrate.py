"""KV block-chain migration: a finished prefill's cache as a value that
moves between engines.

Counterpart of deeplearning4j_tpu/serving/kv/migrate.py, the same wire
format byte for byte -- the same JSON keys, leaf ``path`` strings, dtype
names, base64 of the raw row bytes and blake2b checksum -- so a payload
moves between the two packages in both directions. Prefill/decode
disaggregation needs one primitive: move a request's block chain (not the
whole pool) to another engine so that the decode continued there is what
it would have been locally. The engine gathers and scatters the rows
(``DecodeEngine.kv_export`` / ``kv_import``); this module packs and
checks them.

A payload carries ``n`` chain blocks as one gather per pool leaf (``(n,
block_size, H, Dh)``, base64 of the raw bytes), the token chain that keys
them, and an envelope: the serving weights' ``model_sig``, the serving
precision, the block size and the vocabulary. ``unpack_chain`` validates
the whole payload -- envelope, leaf set, each leaf's dtype and shape, byte
counts and the checksum -- before it returns anything, so a torn or
mismatched import is rejected with the destination pool untouched. Page
tables never travel: the destination allocates fresh blocks and indexes
them under the same chain hashes (kv/prefix.py), so the continued decode
is an ordinary prefix-cache hit.

Rows are numpy arrays. numpy has no bfloat16: a bfloat16 leaf travels as
its raw 16-bit words (``uint16`` rows) labelled ``"bfloat16"``, as the JAX
wire labels it; ``row_dtype`` names a leaf's wire dtype either way.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

FORMAT = "dl4jtpu/kv-migrate/v1"

# envelope fields that must match the destination engine exactly
ENVELOPE_FIELDS = ("model_sig", "precision", "block_size", "vocab")

# wire dtype name -> (numpy dtype the raw rows are held in, item size)
_WIRE_DTYPES = {"bfloat16": np.uint16}


class KVMigrateError(Exception):
    """Import or export rejected; ``reason`` is a bounded label (format /
    model_sig / precision / block_size / vocab / tokens / leaves / dtype /
    shape / torn / no_chain / exhausted) for the reject counter."""

    def __init__(self, msg: str, reason: str = "format"):
        super().__init__(msg)
        self.reason = reason


def row_dtype(leaf) -> str:
    """The wire dtype name of a pool leaf (a tensor or a numpy array):
    numpy's name, with torch's ``bfloat16`` kept as such."""
    return str(leaf.dtype).replace("torch.", "")


def _checksum(leaves: Sequence[Tuple[str, bytes]]) -> str:
    csum = hashlib.blake2b(digest_size=16)
    for key, raw in leaves:
        csum.update(key.encode())
        csum.update(b"|")
        csum.update(raw)
    return csum.hexdigest()


def pack_chain(rows: Dict[str, np.ndarray], tokens: Sequence[int],
               envelope: dict, dtypes: Dict[str, str] = None) -> dict:
    """Serialize gathered chain rows (leaf key -> ``(n, bs, H, Dh)``)
    into a JSON-safe payload. ``tokens`` is the chain's full-block token
    prefix (``n * block_size`` of them); ``dtypes`` names a leaf's wire
    dtype where it is not the array's own (bfloat16 rows held as
    uint16)."""
    bs = int(envelope["block_size"])
    toks = [int(t) for t in tokens]
    n = len(toks) // bs
    if n < 1 or len(toks) != n * bs:
        raise KVMigrateError(
            f"token chain length {len(toks)} is not a positive multiple "
            f"of block_size {bs}", reason="tokens")
    leaves: List[dict] = []
    raws: List[Tuple[str, bytes]] = []
    for key in sorted(rows):
        a = np.ascontiguousarray(rows[key])
        raw = a.tobytes()
        raws.append((key, raw))
        leaves.append({"path": key,
                       "dtype": (dtypes or {}).get(key, str(a.dtype)),
                       "shape": list(a.shape),
                       "data": base64.b64encode(raw).decode("ascii")})
    out = dict(envelope)
    out.update({"format": FORMAT, "n_blocks": n, "tokens": toks,
                "leaves": leaves, "checksum": _checksum(raws)})
    return out


def unpack_chain(payload: dict, envelope: dict, pool_leaves: Dict[str, object]
                 ) -> Tuple[List[int], Dict[str, np.ndarray]]:
    """Validate ``payload`` against the destination engine's envelope and
    pool leaves (key -> anything with ``dtype`` and ``shape``); return
    ``(tokens, rows)`` keyed like ``pool_leaves``, each ``(n, bs, H, Dh)``
    (bfloat16 rows as uint16 words). Raises ``KVMigrateError`` on every
    mismatch, malformation or torn byte, before anything is returned."""
    if not isinstance(payload, dict):
        raise KVMigrateError("payload must be a JSON object",
                             reason="format")
    if payload.get("format") != FORMAT:
        raise KVMigrateError(
            f"unknown payload format {payload.get('format')!r} "
            f"(want {FORMAT!r})", reason="format")
    for fld in ENVELOPE_FIELDS:
        if payload.get(fld) != envelope[fld]:
            raise KVMigrateError(
                f"envelope mismatch on {fld}: payload has "
                f"{payload.get(fld)!r}, destination serves "
                f"{envelope[fld]!r}", reason=fld)
    bs = int(envelope["block_size"])
    tokens = payload.get("tokens")
    n = payload.get("n_blocks")
    if (not isinstance(n, int) or n < 1 or not isinstance(tokens, list)
            or len(tokens) != n * bs
            or not all(isinstance(t, int) for t in tokens)):
        raise KVMigrateError(
            f"token chain does not cover n_blocks={n!r} full blocks of "
            f"{bs}", reason="tokens")
    vocab = int(envelope["vocab"])
    if not all(0 <= t < vocab for t in tokens):
        raise KVMigrateError(
            f"token ids out of range for vocab {vocab}", reason="tokens")
    leaves = payload.get("leaves")
    if not isinstance(leaves, list) or not all(
            isinstance(l, dict) for l in leaves):
        raise KVMigrateError("leaves must be a list of objects",
                             reason="leaves")
    got = sorted(str(l.get("path")) for l in leaves)
    want = sorted(pool_leaves)
    if got != want:
        raise KVMigrateError(
            f"pool leaf set mismatch: payload has {got}, destination "
            f"pool has {want}", reason="leaves")
    rows: Dict[str, np.ndarray] = {}
    raws: List[Tuple[str, bytes]] = []
    for leaf in sorted(leaves, key=lambda l: str(l["path"])):
        key = str(leaf["path"])
        dest = pool_leaves[key]
        name = row_dtype(dest)
        dtype = np.dtype(_WIRE_DTYPES.get(name, name))
        if leaf.get("dtype") != name:
            raise KVMigrateError(
                f"leaf {key}: payload dtype {leaf.get('dtype')!r} != "
                f"destination pool dtype {name!r}", reason="dtype")
        shape = tuple(int(s) for s in leaf.get("shape", ()))
        want_shape = (n,) + tuple(int(s) for s in dest.shape[1:])
        if shape != want_shape:
            raise KVMigrateError(
                f"leaf {key}: row shape {shape} != destination "
                f"{want_shape}", reason="shape")
        try:
            raw = base64.b64decode(leaf.get("data", ""), validate=True)
        except Exception:
            raise KVMigrateError(
                f"leaf {key}: undecodable block data", reason="torn")
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if len(raw) != nbytes:
            raise KVMigrateError(
                f"leaf {key}: torn payload -- {len(raw)} bytes for a "
                f"{shape} {name} gather ({nbytes} expected)",
                reason="torn")
        raws.append((key, raw))
        rows[key] = np.frombuffer(raw, dtype=dtype).reshape(shape)
    if _checksum(raws) != payload.get("checksum"):
        raise KVMigrateError("payload checksum mismatch", reason="torn")
    return [int(t) for t in tokens], rows
