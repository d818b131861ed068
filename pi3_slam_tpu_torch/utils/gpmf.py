"""GPMF (GoPro Metadata Format) extraction from MP4 — pure numpy.

The port's own copy of ``pi3_slam_tpu/utils/gpmf.py`` (the port imports
nothing of the JAX package); the two are held to each other on the CPU.

The reference imports GoPro telemetry only from PRE-EXTRACTED JSON (the
gopro-telemetry node tool or pygpmf output, utils/telemetry_converter.py:
46-345). This module goes further and parses the camera MP4 directly:

  1. walk the MP4 (ISO BMFF) box tree to the 'gpmd'-handler metadata track
     (moov > trak > mdia: hdlr type 'meta', stsd entry 'gpmd'), collect its
     sample offsets/sizes/durations from stbl (stsz / stsc / stco / co64 /
     stts) and the mdhd timescale;
  2. decode each sample's GPMF KLV stream (fourcc key, 1-byte type, 1-byte
     struct size, 2-byte big-endian repeat, 4-byte aligned payloads; type 0
     nests) — DEVC > STRM containers with sensor arrays + SCAL divisors;
  3. distribute the samples of each payload uniformly over the payload's
     time window (the gpmf-parser convention) and apply the reference's axis
     remaps: ACCL/GYRO value order [1,2,0] (:111-115), CORI w,x,z,y ->
     x,y,z,w (:117-119), GRAV [0,2,1] (:120-124), GPS5 lat/lon/alt with
     GPSF fix filtering (:128-134).

No external extractor needed; works on any GoPro HERO5+ MP4.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# GPMF scalar type -> numpy dtype (big-endian)
_GPMF_DTYPES = {
    b"b": ">i1",
    b"B": ">u1",
    b"s": ">i2",
    b"S": ">u2",
    b"l": ">i4",
    b"L": ">u4",
    b"j": ">i8",
    b"J": ">u8",
    b"f": ">f4",
    b"d": ">f8",
    b"q": ">i4",  # Q15.16 fixed point (scaled by 2^16 below)
    b"Q": ">i8",  # Q31.32
}


# ---------------------------------------------------------------------------
# KLV stream parsing
# ---------------------------------------------------------------------------


def parse_klv(buf: bytes) -> List[Tuple[bytes, object]]:
    """Parse one GPMF buffer into a list of (fourcc, value) items.

    Containers (type 0) recurse into nested lists; scalar arrays become
    (repeat, struct_size/elem) numpy arrays; strings/fourccs stay bytes.
    """
    out: List[Tuple[bytes, object]] = []
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        key = buf[pos : pos + 4]
        typ = buf[pos + 4 : pos + 5]
        ssize = buf[pos + 5]
        repeat = struct.unpack(">H", buf[pos + 6 : pos + 8])[0]
        size = ssize * repeat
        payload = buf[pos + 8 : pos + 8 + size]
        pos += 8 + ((size + 3) // 4) * 4  # 4-byte aligned

        if key == b"\x00\x00\x00\x00":
            break
        if typ == b"\x00":  # nested container
            out.append((key, parse_klv(payload)))
            continue
        if typ in (b"c", b"u", b"U"):
            out.append((key, payload[:size]))
            continue
        if typ == b"F":
            out.append((key, [payload[i : i + 4] for i in range(0, size, 4)]))
            continue
        dt = _GPMF_DTYPES.get(typ)
        if dt is None:  # unknown/complex type: keep raw bytes
            out.append((key, payload[:size]))
            continue
        elem = np.dtype(dt).itemsize
        per = max(1, ssize // elem)
        arr = np.frombuffer(payload[: repeat * per * elem], dtype=dt).astype(np.float64)
        if typ == b"q":
            arr = arr / 65536.0
        elif typ == b"Q":
            arr = arr / 4294967296.0
        out.append((key, arr.reshape(repeat, per) if per > 1 else arr))
    return out


def _find(items, key: bytes):
    for k, v in items:
        if k == key:
            return v
    return None


def _find_all(items, key: bytes):
    return [v for k, v in items if k == key]


def extract_streams(payload_items) -> Dict[bytes, Dict]:
    """DEVC payload items -> {sensor_fourcc: {'data': (N, C), 'scal': ...}}."""
    out: Dict[bytes, Dict] = {}
    for devc in _find_all(payload_items, b"DEVC"):
        for strm in _find_all(devc, b"STRM"):
            scal = _find(strm, b"SCAL")
            for key, val in strm:
                if key in (
                    b"ACCL", b"GYRO", b"GRAV", b"CORI", b"IORI",
                    b"GPS5", b"GPSF", b"GPSP", b"GPSU", b"MAGN",
                ) and isinstance(val, np.ndarray):
                    data = np.atleast_2d(val.astype(np.float64))
                    if scal is not None:
                        s = np.asarray(scal, np.float64).reshape(-1)
                        if s.size == data.shape[1]:
                            data = data / s[None, :]
                        elif s.size >= 1:
                            data = data / s.flat[0]
                    entry = out.setdefault(key, {"data": []})
                    entry["data"].append(data)
    return out


# ---------------------------------------------------------------------------
# MP4 (ISO BMFF) box walking
# ---------------------------------------------------------------------------


def _iter_boxes(data: memoryview, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        kind = bytes(data[pos + 4 : pos + 8])
        header = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header:
            return
        yield kind, pos + header, min(pos + size, end)
        pos += size


def _child(data, start, end, *path):
    """Descend a box path; returns (start, end) of the innermost box."""
    for name in path:
        found = None
        for kind, s, e in _iter_boxes(data, start, end):
            if kind == name:
                found = (s, e)
                break
        if found is None:
            return None
        start, end = found
    return start, end


class _Track:
    handler: bytes = b""
    codec: bytes = b""
    timescale: int = 1
    sample_sizes: np.ndarray = None
    chunk_offsets: np.ndarray = None
    stsc: list = None
    durations: np.ndarray = None


def _parse_track(data, s, e) -> Optional[_Track]:
    t = _Track()
    mdia = _child(data, s, e, b"mdia")
    if mdia is None:
        return None
    ms, me = mdia
    mdhd = _child(data, ms, me, b"mdhd")
    if mdhd:
        hs, _ = mdhd
        version = data[hs]
        t.timescale = struct.unpack(
            ">I", data[hs + (20 if version else 12) : hs + (24 if version else 16)]
        )[0]
    hdlr = _child(data, ms, me, b"hdlr")
    if hdlr:
        hs, _ = hdlr
        t.handler = bytes(data[hs + 8 : hs + 12])
    stbl = _child(data, ms, me, b"minf", b"stbl")
    if stbl is None:
        return None
    ss, se = stbl
    stsd = _child(data, ss, se, b"stsd")
    if stsd:
        ds, _ = stsd
        t.codec = bytes(data[ds + 12 : ds + 16])
    stsz = _child(data, ss, se, b"stsz")
    if stsz:
        zs, _ = stsz
        uniform, count = struct.unpack(">II", data[zs + 4 : zs + 12])
        if uniform:
            t.sample_sizes = np.full(count, uniform, np.int64)
        else:
            t.sample_sizes = np.frombuffer(
                data[zs + 12 : zs + 12 + 4 * count], ">u4"
            ).astype(np.int64)
    co = _child(data, ss, se, b"stco")
    if co:
        cs, _ = co
        count = struct.unpack(">I", data[cs + 4 : cs + 8])[0]
        t.chunk_offsets = np.frombuffer(data[cs + 8 : cs + 8 + 4 * count], ">u4").astype(np.int64)
    else:
        co = _child(data, ss, se, b"co64")
        if co:
            cs, _ = co
            count = struct.unpack(">I", data[cs + 4 : cs + 8])[0]
            t.chunk_offsets = np.frombuffer(data[cs + 8 : cs + 8 + 8 * count], ">u8").astype(np.int64)
    stsc = _child(data, ss, se, b"stsc")
    if stsc:
        cs, _ = stsc
        count = struct.unpack(">I", data[cs + 4 : cs + 8])[0]
        rows = np.frombuffer(data[cs + 8 : cs + 8 + 12 * count], ">u4").reshape(count, 3)
        t.stsc = rows.astype(np.int64)
    stts = _child(data, ss, se, b"stts")
    if stts:
        ts, _ = stts
        count = struct.unpack(">I", data[ts + 4 : ts + 8])[0]
        rows = np.frombuffer(data[ts + 8 : ts + 8 + 8 * count], ">u4").reshape(count, 2)
        t.durations = np.repeat(rows[:, 1], rows[:, 0]).astype(np.int64)
    return t


def _track_samples(data, t: _Track) -> List[Tuple[int, int]]:
    """(offset, size) of every sample via stsc chunk mapping."""
    if t.sample_sizes is None or t.chunk_offsets is None:
        return []
    n_chunks = len(t.chunk_offsets)
    spc = np.ones(n_chunks, np.int64)
    if t.stsc is not None and len(t.stsc):
        for i, (first, count, _) in enumerate(t.stsc):
            last = t.stsc[i + 1][0] - 1 if i + 1 < len(t.stsc) else n_chunks
            spc[int(first) - 1 : int(last)] = count
    samples = []
    si = 0
    for ci in range(n_chunks):
        off = int(t.chunk_offsets[ci])
        for _ in range(int(spc[ci])):
            if si >= len(t.sample_sizes):
                break
            size = int(t.sample_sizes[si])
            samples.append((off, size))
            off += size
            si += 1
    return samples


def parse_gpmf_mp4(path: str) -> Dict:
    """Extract GPMF payloads + per-payload times and video fps from an MP4.

    Returns {'payloads': [KLV item list per sample], 'payload_times_s': (N,),
    'payload_durations_s': (N,), 'camera_fps': float}.
    """
    with open(path, "rb") as f:
        raw = f.read()
    data = memoryview(raw)
    moov = _child(data, 0, len(raw), b"moov")
    if moov is None:
        raise IOError(f"{path}: no moov box (not an MP4?)")
    gp_track = None
    fps = 0.0
    for kind, s, e in _iter_boxes(data, *moov):
        if kind != b"trak":
            continue
        t = _parse_track(data, s, e)
        if t is None:
            continue
        if t.handler == b"meta" and t.codec == b"gpmd":
            gp_track = t
        elif t.handler == b"vide" and t.durations is not None and len(t.durations):
            fps = float(t.timescale) / float(np.median(t.durations))
    if gp_track is None:
        raise IOError(f"{path}: no GPMF (gpmd) metadata track")

    samples = _track_samples(data, gp_track)
    payloads = [parse_klv(raw[off : off + size]) for off, size in samples]
    if gp_track.durations is not None and len(gp_track.durations) >= len(samples):
        dur = gp_track.durations[: len(samples)] / float(gp_track.timescale)
    else:
        dur = np.full(len(samples), 1.001, np.float64)
    times = np.concatenate([[0.0], np.cumsum(dur)[:-1]])
    return {
        "payloads": payloads,
        "payload_times_s": times,
        "payload_durations_s": np.asarray(dur, np.float64),
        "camera_fps": fps,
    }


# ---------------------------------------------------------------------------
# stream assembly with reference axis remaps
# ---------------------------------------------------------------------------


def gopro_telemetry_from_mp4(path: str) -> Dict[str, np.ndarray]:
    """Full GoPro telemetry with the reference's axis conventions.

    Returns a dict with accl/gyro/grav/cori/gps arrays and *_t second
    timestamps (uniform within each payload window), plus camera_fps.
    """
    parsed = parse_gpmf_mp4(path)
    # stream fourcc -> {payload_index: (n_samples, C) array}
    per_payload: Dict[bytes, Dict[int, np.ndarray]] = {}
    for pi, items in enumerate(parsed["payloads"]):
        for key, entry in extract_streams(items).items():
            per_payload.setdefault(key, {})[pi] = np.concatenate(entry["data"])

    t0s = parsed["payload_times_s"]
    durs = parsed["payload_durations_s"]

    def assemble(key: bytes):
        chunks = per_payload.get(key)
        if not chunks:
            return np.zeros(0), np.zeros((0, 1))
        ts, vals = [], []
        for i in sorted(chunks):
            if i >= len(t0s):
                continue
            c = chunks[i]
            n = len(c)
            if n == 0:
                continue
            ts.append(t0s[i] + np.arange(n) * (durs[i] / n))
            vals.append(c)
        if not vals:
            return np.zeros(0), np.zeros((0, 1))
        width = max(v.shape[1] for v in vals)
        vals = [
            v if v.shape[1] == width else np.pad(v, ((0, 0), (0, width - v.shape[1])))
            for v in vals
        ]
        return np.concatenate(ts), np.concatenate(vals)

    out: Dict[str, np.ndarray] = {"camera_fps": parsed["camera_fps"]}
    accl_t, accl = assemble(b"ACCL")
    gyro_t, gyro = assemble(b"GYRO")
    # reference axis remap: value order [1, 2, 0] (telemetry_converter.py:111-115)
    out["accl_t"], out["accl"] = accl_t, accl[:, [1, 2, 0]] if accl.shape[1] >= 3 else accl
    out["gyro_t"], out["gyro"] = gyro_t, gyro[:, [1, 2, 0]] if gyro.shape[1] >= 3 else gyro
    grav_t, grav = assemble(b"GRAV")
    if grav.shape[1] >= 3:
        # gpmf-parser#170: stream order x, -z, -y -> camera x, y, z via [0, 2, 1]
        grav = grav[:, [0, 2, 1]]
    out["grav_t"], out["grav"] = grav_t, grav
    cori_t, cori = assemble(b"CORI")
    if cori.shape[1] >= 4:
        # gpmf-parser#100: stored w, x, z, y -> quaternion (x, y, z, w)
        cori = cori[:, [1, 3, 2, 0]]
    out["cori_t"], out["cori"] = cori_t, cori
    gps_t, gps = assemble(b"GPS5")
    fix_t, fix = assemble(b"GPSF")
    if gps.shape[0] and fix.shape[0]:
        # sticky fix value; drop no-fix samples (reference :128-134)
        idx = np.clip(np.searchsorted(fix_t, gps_t, side="right") - 1, 0, len(fix) - 1)
        good = fix[idx, 0] > 0
        gps_t, gps = gps_t[good], gps[good]
    out["gps_t"], out["gps"] = gps_t, gps[:, :3] if gps.shape[1] >= 3 else gps
    return out
