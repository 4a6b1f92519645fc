"""KV-state migration wire format + fleet prefix directory (counterpart
of megatron_tpu/inference/fleet/migration.py; the bytes are the JAX
package's, so a frame either package packs, the other unpacks).

The engine exports a request's full resumable state (KV sections +
scales, generated tokens, the sampling chain, sampling knobs:
`InferenceEngine.export_request_state`) as `(meta, sections)`, and this
module turns that into ONE self-verifying byte blob that can cross a
process boundary:

    MAGIC | u32 manifest_len | manifest JSON | section payload bytes

The manifest is the commit record: every section's dtype/shape/offset/
size/crc32 is committed in the header, and `unpack_state` verifies ALL
of it before handing a single array to the engine. A torn transfer
(truncated TCP stream, `migrate_fail` fault injection) therefore fails
loudly with `MigrationIntegrityError` on the import side (the importer
NEVER resumes from a half-received KV cache) and the exporter walks
down the degradation ladder (migrate -> recompute-resume -> retry ->
reject, server.py).

Sections are numpy arrays, or torch tensors of the dtypes numpy cannot
name (bfloat16, float8_e4m3fn, float8_e5m2): those travel as their raw
bytes under the JAX package's dtype name (ml_dtypes' names, which are
torch's), and unpack_state returns them as CPU torch tensors, decoded
through torch (the card's machine need not have ml_dtypes).

Also here, because they are fleet-level concerns with no engine state:

  * `post_blob` / `fetch_prefix` / `replicate_prefix`: the HTTP client
    half of the /admin/import, /admin/export_prefix and
    /admin/import_prefix endpoints (server.py is the other half);
  * `PrefixDirectory`: the router's fleet-level map from a registered
    prefix (system prompt) to the replicas known to hold its pages, so a
    prefix registered on replica A becomes a radix hit on replica B via
    page export instead of a re-prefill.

Host code: numpy + stdlib, and torch only to decode a torch-only dtype,
so the router process never imports torch.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"MTPM"
FORMAT_VERSION = 1

#: header sanity bound: a manifest is a few KB of JSON; anything claiming
#: more is a corrupt length word, not a real manifest
_MAX_MANIFEST_BYTES = 16 * 1024 * 1024


class MigrationIntegrityError(RuntimeError):
    """A migration blob failed its commit contract (magic / manifest /
    length / crc). The transfer is torn or corrupt; the importer must
    reject it and the exporter must degrade down the ladder."""


#: the wire dtypes numpy cannot name, by their (ml_dtypes = torch) name
_TORCH_ONLY = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _raw(arr) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw bytes) of a numpy array or a torch
    tensor (a torch-only dtype as its bytes under its name)."""
    if isinstance(arr, np.ndarray):
        arr = np.ascontiguousarray(arr)
        return arr.dtype.name, list(arr.shape), arr.tobytes()
    import torch

    t = arr.detach().contiguous().cpu()
    name = str(t.dtype).replace("torch.", "")
    if name in _TORCH_ONLY:
        bits = torch.int16 if t.element_size() == 2 else torch.int8
        return name, list(t.shape), t.view(bits).numpy().tobytes()
    return _raw(t.numpy())


def _decode(raw: bytes, name: str, shape):
    """A section's array: numpy, or for a torch-only dtype a CPU torch
    tensor decoded through torch."""
    if name in _TORCH_ONLY:
        import torch

        dt = getattr(torch, name)
        bits = torch.int16 if dt.itemsize == 2 else torch.int8
        flat = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(
            "int16" if bits == torch.int16 else "int8")).copy())
        return flat.view(dt).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def pack_state(meta: Dict[str, Any], sections: Dict[str, Any]) -> bytes:
    """Serialise `(meta, sections)` into one self-verifying blob.

    Section payloads are concatenated in sorted-name order; the manifest
    commits each section's dtype/shape/offset/size/crc32 plus the caller's
    `meta` dict, so `unpack_state` can verify the whole frame before
    reconstructing any array.
    """
    entries: Dict[str, Dict[str, Any]] = {}
    payload: List[bytes] = []
    offset = 0
    for name in sorted(sections):
        dtype, shape, raw = _raw(sections[name])
        entries[name] = {
            "dtype": dtype,
            "shape": shape,
            "offset": offset,
            "size": len(raw),
            "crc32": f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}",
        }
        payload.append(raw)
        offset += len(raw)
    head = json.dumps(
        {"format": FORMAT_VERSION, "meta": meta, "sections": entries},
        sort_keys=True).encode("utf-8")
    return b"".join(
        [MAGIC, len(head).to_bytes(4, "big"), head] + payload)


def unpack_state(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Verify and deserialise a `pack_state` blob.

    Raises MigrationIntegrityError on ANY contract violation: bad magic,
    truncated header, unknown format version, payload shorter/longer than
    the manifest committed, or a per-section crc mismatch. Returns the
    `(meta, sections)` the exporter packed.
    """
    if len(blob) < len(MAGIC) + 4 or blob[:len(MAGIC)] != MAGIC:
        raise MigrationIntegrityError(
            "migration blob: bad magic (not a migration frame, or the "
            "header itself was torn)")
    head_len = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 4], "big")
    body_at = len(MAGIC) + 4
    if head_len > _MAX_MANIFEST_BYTES or body_at + head_len > len(blob):
        raise MigrationIntegrityError(
            f"migration blob: manifest length {head_len} exceeds frame "
            f"({len(blob)} bytes) — torn header")
    try:
        frame = json.loads(blob[body_at:body_at + head_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MigrationIntegrityError(
            f"migration blob: manifest is not valid JSON ({e})") from e
    if frame.get("format") != FORMAT_VERSION:
        raise MigrationIntegrityError(
            f"migration blob: format {frame.get('format')!r} != "
            f"{FORMAT_VERSION}")
    entries = frame.get("sections", {})
    payload = blob[body_at + head_len:]
    total = sum(int(e["size"]) for e in entries.values())
    if len(payload) != total:
        raise MigrationIntegrityError(
            f"migration blob: payload is {len(payload)} bytes, manifest "
            f"committed {total} — torn transfer")
    sections: Dict[str, np.ndarray] = {}
    for name, e in entries.items():
        raw = payload[int(e["offset"]):int(e["offset"]) + int(e["size"])]
        if len(raw) != int(e["size"]):
            raise MigrationIntegrityError(
                f"migration blob: section {name!r} truncated")
        crc = f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}"
        if crc != e["crc32"]:
            raise MigrationIntegrityError(
                f"migration blob: section {name!r} crc {crc} != committed "
                f"{e['crc32']}")
        sections[name] = _decode(raw, e["dtype"], e["shape"])
    return frame.get("meta", {}), sections


def blob_wire_bytes(blob: bytes) -> int:
    """The manifest cost model: what the comm ledger charges for a
    transfer is exactly what went on the wire — the full frame."""
    return len(blob)


# ----- HTTP client half ------------------------------------------------


def post_blob(url: str, blob: bytes,
              timeout: float = 60.0) -> Tuple[int, Dict[str, Any]]:
    """POST a migration blob as application/octet-stream.

    Returns (status, parsed-JSON-body-or-{}). Transport errors surface as
    status 0 with the error text under "error" — callers treat any
    non-200 as a failed rung and degrade, so exceptions never escape.
    """
    req = urllib.request.Request(
        url, data=blob, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        body = e.read()
        status = e.code
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        return 0, {"error": str(e)}
    try:
        return status, json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return status, {}


def fetch_prefix(url: str, tokens: Sequence[int],
                 timeout: float = 60.0) -> Optional[bytes]:
    """GET a packed prefix-state blob from a replica's
    /admin/export_prefix. Returns None when the replica does not hold the
    prefix (404) or cannot be reached."""
    body = json.dumps({"tokens": [int(t) for t in tokens]}).encode("utf-8")
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            return resp.read()
    except (urllib.error.URLError, OSError, TimeoutError):
        return None


def replicate_prefix(src_url: str, dest_urls: Sequence[str],
                     tokens: Sequence[int],
                     timeout: float = 60.0) -> Dict[str, Any]:
    """Fan a cached prefix out from one replica to its peers via page
    export: fetch the packed pages from `src_url`'s /admin/export_prefix
    and POST them to each destination's /admin/import_prefix.

    Returns {"replicated": [{"url", "status", "pages"}...], "bytes": N}
    where bytes is the wire cost of ONE transfer (the same blob is reused
    for every destination; the ledger multiplies by fan-out).
    """
    blob = fetch_prefix(src_url + "/admin/export_prefix", tokens,
                        timeout=timeout)
    if blob is None:
        return {"replicated": [], "bytes": 0}
    out: List[Dict[str, Any]] = []
    for dest in dest_urls:
        status, body = post_blob(dest + "/admin/import_prefix", blob,
                                 timeout=timeout)
        out.append({"url": dest, "status": status,
                    "pages": int(body.get("pages", 0)) if body else 0})
    return {"replicated": out, "bytes": blob_wire_bytes(blob)}


# ----- fleet prefix directory ------------------------------------------


class PrefixDirectory:
    """Fleet-level map: registered prefix -> replicas known to hold its
    pages. The router records every successful register/replicate here so
    dispatch (and operators, via snapshot()) can see which replicas will
    radix-hit a given system prompt. Thread-safe; host memory only."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._where: Dict[Tuple[int, ...], set] = {}

    def register(self, tokens: Sequence[int], url: str) -> None:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            self._where.setdefault(key, set()).add(url)

    def forget_replica(self, url: str) -> None:
        with self._lock:
            for urls in self._where.values():
                urls.discard(url)

    def locations(self, tokens: Sequence[int]) -> List[str]:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            return sorted(self._where.get(key, ()))

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"prefix_len": len(k), "prefix_head": list(k[:8]),
                     "replicas": sorted(v)}
                    for k, v in self._where.items()]
