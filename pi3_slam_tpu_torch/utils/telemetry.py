"""IMU / GPS telemetry import + export.

The port's own copy of ``pi3_slam_tpu/utils/telemetry.py`` (numpy only; the
port imports nothing of the JAX package): the reference's
``utils/telemetry_converter.py`` importers (GoPro GPMF, generic JSON, CSV,
ZED jsonl) with accelerometer, gyroscope, gravity and GPS streams, and its
exporters (a generic JSON and a Kalibr-style CSV). The gravity and GPS
streams feed the BA constraints of ``sfm/priors.py`` (the CLIs'
``--telemetry``).

Data model: all streams are seconds-based numpy arrays.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class TelemetryData:
    accl_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    accl: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    gyro_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    gyro: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    grav_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    grav: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    gps_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    gps: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))  # lat, lon, alt
    cori_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cori: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))  # x, y, z, w
    camera_fps: float = 0.0


class TelemetryImporter:
    """Read telemetry from the supported container formats."""

    def __init__(self):
        self.telemetry = TelemetryData()

    # --- importers ---

    def read_generic_json(self, path: str) -> TelemetryData:
        """{'1': {'streams': {'ACCL': {'samples': [{'value': [...], 'cts': ms}]}}}}
        or the flat {'accelerometer': [[t,x,y,z],...]} layout."""
        with open(path) as f:
            data = json.load(f)
        t = TelemetryData()
        if any(k in data for k in ("accelerometer", "gyroscope", "gravity", "gps")):
            acc = np.asarray(data.get("accelerometer", []), np.float64).reshape(-1, 4)
            gyr = np.asarray(data.get("gyroscope", []), np.float64).reshape(-1, 4)
            t.accl_t, t.accl = acc[:, 0], acc[:, 1:]
            t.gyro_t, t.gyro = gyr[:, 0], gyr[:, 1:]
            if "gravity" in data:
                g = np.asarray(data["gravity"], np.float64).reshape(-1, 4)
                t.grav_t, t.grav = g[:, 0], g[:, 1:]
            if "gps" in data:
                g = np.asarray(data["gps"], np.float64).reshape(-1, 4)
                t.gps_t, t.gps = g[:, 0], g[:, 1:]
            t.camera_fps = float(data.get("camera_fps", 0.0))
        else:  # gopro-telemetry style streams, the reference's axis conventions
            streams = data.get("1", {}).get("streams", {})

            def stream(name, width=3):
                samples = streams.get(name, {}).get("samples", [])
                if not samples:
                    return np.zeros(0), np.zeros((0, width))
                ts = np.asarray([s["cts"] for s in samples], np.float64) / 1e3
                vals = np.asarray([s["value"][:width] for s in samples], np.float64)
                return ts, vals

            t.accl_t, accl = stream("ACCL")
            t.gyro_t, gyro = stream("GYRO")
            # the reference's remap: stream order z, x, y -> camera x, y, z
            # via [1, 2, 0]
            t.accl = accl[:, [1, 2, 0]] if accl.size else accl
            t.gyro = gyro[:, [1, 2, 0]] if gyro.size else gyro
            t.grav_t, grav = stream("GRAV")
            # gpmf-parser#170: x, -z, -y -> [0, 2, 1]
            t.grav = grav[:, [0, 2, 1]] if grav.size else grav
            t.cori_t, cori = stream("CORI", width=4)
            # gpmf-parser#100: stored w, x, z, y -> (x, y, z, w)
            t.cori = cori[:, [1, 3, 2, 0]] if cori.size else cori
            # GPS5: drop no-fix samples as the reference does
            samples = streams.get("GPS5", {}).get("samples", [])
            good = [s for s in samples if s.get("fix", 1) != 0]
            if good:
                t.gps_t = np.asarray([s["cts"] for s in good], np.float64) / 1e3
                t.gps = np.asarray([s["value"][:3] for s in good], np.float64)
        self.telemetry = t
        return t

    def read_csv(self, path: str, time_scale: float = 1.0) -> TelemetryData:
        """Kalibr-style CSV: timestamp, gx, gy, gz, ax, ay, az."""
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(v) for v in row[:7]])
        arr = np.asarray(rows, np.float64)
        t = TelemetryData()
        if arr.size:
            t.accl_t = t.gyro_t = arr[:, 0] * time_scale
            t.gyro = arr[:, 1:4]
            t.accl = arr[:, 4:7]
        self.telemetry = t
        return t

    def read_zed_jsonl(self, path: str) -> TelemetryData:
        """ZED SDK jsonl: one {'timestamp': ns, 'linear_acceleration': [...],
        'angular_velocity': [...]} per line."""
        ts, acc, gyr = [], [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                ts.append(d["timestamp"] / 1e9)
                acc.append(d.get("linear_acceleration", [0, 0, 0]))
                gyr.append(d.get("angular_velocity", [0, 0, 0]))
        t = TelemetryData()
        t.accl_t = t.gyro_t = np.asarray(ts)
        t.accl = np.asarray(acc, np.float64)
        t.gyro = np.asarray(gyr, np.float64)
        self.telemetry = t
        return t

    def read_gopro_mp4(self, path: str) -> TelemetryData:
        """Parse GPMF telemetry directly from a GoPro MP4 (``utils/gpmf.py``,
        no external extractor), with the reference's axis remaps (ACCL / GYRO
        [1, 2, 0], GRAV [0, 2, 1], CORI wxzy -> xyzw)."""
        from .gpmf import gopro_telemetry_from_mp4

        g = gopro_telemetry_from_mp4(path)
        t = TelemetryData()
        t.accl_t, t.accl = g["accl_t"], g["accl"]
        t.gyro_t, t.gyro = g["gyro_t"], g["gyro"]
        t.grav_t, t.grav = g["grav_t"], g["grav"]
        t.cori_t, t.cori = g["cori_t"], g["cori"]
        t.gps_t, t.gps = g["gps_t"], g["gps"]
        t.camera_fps = float(g["camera_fps"])
        self.telemetry = t
        return t

    # --- interpolation helpers ---

    def gravity_at_times(self, times: np.ndarray) -> np.ndarray:
        t = self.telemetry
        if t.grav_t.size == 0:
            raise ValueError("no gravity stream")
        out = np.stack(
            [np.interp(times, t.grav_t, t.grav[:, i]) for i in range(3)], axis=1
        )
        n = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(n, 1e-12)

    def gps_at_times(self, times: np.ndarray) -> np.ndarray:
        t = self.telemetry
        if t.gps_t.size == 0:
            raise ValueError("no gps stream")
        return np.stack(
            [np.interp(times, t.gps_t, t.gps[:, i]) for i in range(3)], axis=1
        )


def load_telemetry(path: str) -> "TelemetryImporter":
    """Importer auto-dispatched by file extension: .mp4 (GoPro GPMF), .jsonl
    (ZED), .csv, anything else = generic JSON."""
    imp = TelemetryImporter()
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mp4":
        imp.read_gopro_mp4(path)
    elif ext == ".jsonl":
        imp.read_zed_jsonl(path)
    elif ext == ".csv":
        imp.read_csv(path)
    else:
        imp.read_generic_json(path)
    return imp


class TelemetryConverter:
    """Exporters: a generic JSON and a Kalibr-style CSV."""

    def __init__(self, importer: TelemetryImporter):
        self.t = importer.telemetry

    def to_json(self, path: str) -> None:
        t = self.t
        data = {
            "accelerometer": np.concatenate([t.accl_t[:, None], t.accl], axis=1).tolist(),
            "gyroscope": np.concatenate([t.gyro_t[:, None], t.gyro], axis=1).tolist(),
            "camera_fps": t.camera_fps,
        }
        if t.grav_t.size:
            data["gravity"] = np.concatenate([t.grav_t[:, None], t.grav], axis=1).tolist()
        if t.gps_t.size:
            data["gps"] = np.concatenate([t.gps_t[:, None], t.gps], axis=1).tolist()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(data, f)

    def to_kalibr_csv(self, path: str, time_scale_ns: bool = True) -> None:
        """timestamp[ns], gx, gy, gz, ax, ay, az (IMU rows merged on the
        accelerometer timeline)."""
        t = self.t
        gyro_interp = np.stack(
            [np.interp(t.accl_t, t.gyro_t, t.gyro[:, i]) for i in range(3)], axis=1
        ) if t.gyro_t.size else np.zeros_like(t.accl)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write("#timestamp,gx,gy,gz,ax,ay,az\n")
            for i, ts in enumerate(t.accl_t):
                stamp = int(ts * 1e9) if time_scale_ns else ts
                g = gyro_interp[i]
                a = t.accl[i]
                f.write(f"{stamp},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")
