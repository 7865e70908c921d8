"""Minimal Waymo Open Dataset Frame decoder: the protobuf wire format in
pure Python.

A copy of `mudg_tpu/data/waymo_proto.py` (host code; the port imports
nothing of the JAX package). It stands in for
`waymo_open_dataset.dataset_pb2` (`data_process/preprocess.py:54-61`) and
reads exactly the fields the ETL consumes. Unknown fields are skipped by the
protobuf wire rules, so schema additions in newer dataset releases do not
break decoding.

Field numbers follow the public waymo-open-dataset protos
(`waymo_open_dataset/dataset.proto`, `label.proto`):

    Frame:    context=1, timestamp_micros=2, pose=3, images=4, lasers=5,
              laser_labels=6
    Context:  name=1, camera_calibrations=2, laser_calibrations=3
    CameraCalibration: name=1, intrinsic=2, extrinsic=3, width=4, height=5,
              rolling_shutter_direction=6
    LaserCalibration:  name=1, beam_inclinations=2, beam_inclination_min=3,
              beam_inclination_max=4, extrinsic=5
    CameraImage: name=1, image=2, pose=3, velocity=4, pose_timestamp=5,
              shutter=6, camera_trigger_time=7, camera_readout_done_time=8
    Laser:    name=1, ri_return1=2, ri_return2=3
    RangeImage: range_image=1 (deprecated MatrixFloat),
              range_image_compressed=2, camera_projection_compressed=3,
              range_image_pose_compressed=4
    MatrixFloat: data=1 (packed float), shape=2 {dims=1 (packed int32)}
    Transform: transform=1 (repeated double)
    Label:    box=1, metadata=2, type=3, id=4
    Label.Box: center_x=1, center_y=2, center_z=3, width=4, length=5,
              height=6, heading=7
    Label.Metadata: speed_x=1, speed_y=2, accel_x=3, accel_y=4

Repeated scalars accept both packed (length-delimited) and unpacked
encodings, as required by proto3 parsers.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterator

import numpy as np

# camera / lidar enum name tables (dataset.proto CameraName / LaserName)
CAMERA_NAMES = {1: "FRONT", 2: "FRONT_LEFT", 3: "FRONT_RIGHT",
                4: "SIDE_LEFT", 5: "SIDE_RIGHT"}
LASER_NAMES = {1: "TOP", 2: "FRONT", 3: "SIDE_LEFT", 4: "SIDE_RIGHT",
               5: "REAR"}
# label.proto Label.Type
LABEL_TYPES = ("unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist")


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def iter_fields(buf) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). value: int for wt 0,
    float-bits int for wt 1/5 (use struct to reinterpret), memoryview for
    wt 2."""
    buf = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def _double(wt, val) -> float:
    if wt == 1:
        return struct.unpack("<d", val)[0]
    raise ValueError("expected 64-bit field")


def _float(wt, val) -> float:
    if wt == 5:
        return struct.unpack("<f", val)[0]
    raise ValueError("expected 32-bit field")


def _repeated_double(acc: list, wt, val):
    """Handles packed (wt 2) and unpacked (wt 1) repeated doubles."""
    if wt == 2:
        acc.extend(np.frombuffer(val, "<f8"))
    else:
        acc.append(_double(wt, val))


def _repeated_float(acc: list, wt, val):
    if wt == 2:
        acc.extend(np.frombuffer(val, "<f4"))
    else:
        acc.append(_float(wt, val))


def _repeated_varint(acc: list, wt, val):
    if wt == 2:
        pos = 0
        while pos < len(val):
            v, pos = _read_varint(val, pos)
            acc.append(v)
    else:
        acc.append(val)


def _signed32(v: int) -> int:
    """Varints carry negative int32 two's-complement sign-extended to 64
    bits; undo that."""
    v &= (1 << 64) - 1
    if v >= 1 << 63:
        v -= 1 << 64
    return v


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def _parse_transform(buf) -> np.ndarray:
    vals: list = []
    for f, wt, v in iter_fields(buf):
        if f == 1:
            _repeated_double(vals, wt, v)
    a = np.asarray(vals, np.float64)
    return a.reshape(4, 4) if a.size == 16 else a


@dataclasses.dataclass
class CameraCalibration:
    name: int = 0
    intrinsic: np.ndarray = None  # (9,) fx fy cx cy k1 k2 p1 p2 k3
    extrinsic: np.ndarray = None  # (4,4) camera->vehicle
    width: int = 0
    height: int = 0
    rolling_shutter_direction: int = 0


def _parse_camera_calibration(buf) -> CameraCalibration:
    c = CameraCalibration()
    intr: list = []
    for f, wt, v in iter_fields(buf):
        if f == 1:
            c.name = v
        elif f == 2:
            _repeated_double(intr, wt, v)
        elif f == 3:
            c.extrinsic = _parse_transform(v)
        elif f == 4:
            c.width = _signed32(v)
        elif f == 5:
            c.height = _signed32(v)
        elif f == 6:
            c.rolling_shutter_direction = v
    c.intrinsic = np.asarray(intr, np.float64)
    return c


@dataclasses.dataclass
class LaserCalibration:
    name: int = 0
    beam_inclinations: np.ndarray = None
    beam_inclination_min: float = 0.0
    beam_inclination_max: float = 0.0
    extrinsic: np.ndarray = None  # (4,4) lidar->vehicle


def _parse_laser_calibration(buf) -> LaserCalibration:
    c = LaserCalibration()
    incl: list = []
    for f, wt, v in iter_fields(buf):
        if f == 1:
            c.name = v
        elif f == 2:
            _repeated_double(incl, wt, v)
        elif f == 3:
            c.beam_inclination_min = _double(wt, v)
        elif f == 4:
            c.beam_inclination_max = _double(wt, v)
        elif f == 5:
            c.extrinsic = _parse_transform(v)
    c.beam_inclinations = np.asarray(incl, np.float64)
    return c


@dataclasses.dataclass
class Context:
    name: str = ""
    camera_calibrations: list = dataclasses.field(default_factory=list)
    laser_calibrations: list = dataclasses.field(default_factory=list)


def _parse_context(buf) -> Context:
    c = Context()
    for f, wt, v in iter_fields(buf):
        if f == 1:
            c.name = bytes(v).decode("utf-8", "replace")
        elif f == 2:
            c.camera_calibrations.append(_parse_camera_calibration(v))
        elif f == 3:
            c.laser_calibrations.append(_parse_laser_calibration(v))
    return c


@dataclasses.dataclass
class CameraImage:
    name: int = 0
    image: bytes = b""          # JPEG bytes
    pose: np.ndarray = None     # (4,4) vehicle->world at pose_timestamp
    pose_timestamp: float = 0.0
    shutter: float = 0.0
    camera_trigger_time: float = 0.0
    camera_readout_done_time: float = 0.0


def _parse_camera_image(buf) -> CameraImage:
    c = CameraImage()
    for f, wt, v in iter_fields(buf):
        if f == 1:
            c.name = v
        elif f == 2:
            c.image = bytes(v)
        elif f == 3:
            c.pose = _parse_transform(v)
        elif f == 5:
            c.pose_timestamp = _double(wt, v)
        elif f == 6:
            c.shutter = _double(wt, v)
        elif f == 7:
            c.camera_trigger_time = _double(wt, v)
        elif f == 8:
            c.camera_readout_done_time = _double(wt, v)
    return c


def parse_matrix_float(buf) -> np.ndarray:
    """MatrixFloat {data=1 packed float, shape=2{dims=1 packed int32}}.
    Packed runs are kept as arrays and joined once (the JAX copy extends a
    list float by float; the values are the same)."""
    chunks: list = []
    dims: list = []
    for f, wt, v in iter_fields(buf):
        if f == 1:
            chunks.append(np.frombuffer(v, "<f4") if wt == 2
                          else np.array([_float(wt, v)], np.float32))
        elif f == 2:
            for f2, wt2, v2 in iter_fields(v):
                if f2 == 1:
                    _repeated_varint(dims, wt2, v2)
    arr = (np.concatenate(chunks).astype(np.float32) if chunks
           else np.zeros(0, np.float32))
    if dims:
        arr = arr.reshape([_signed32(d) for d in dims])
    return arr


def decode_compressed_matrix(blob: bytes) -> np.ndarray:
    """ZLIB-compressed MatrixFloat -> ndarray (preprocess.py:279-282)."""
    return parse_matrix_float(zlib.decompress(blob))


@dataclasses.dataclass
class RangeImage:
    range_image_compressed: bytes = b""
    camera_projection_compressed: bytes = b""
    range_image_pose_compressed: bytes = b""
    range_image: np.ndarray = None  # deprecated inline MatrixFloat

    def matrix(self) -> np.ndarray:
        if self.range_image_compressed:
            return decode_compressed_matrix(self.range_image_compressed)
        return self.range_image


def _parse_range_image(buf) -> RangeImage:
    r = RangeImage()
    for f, wt, v in iter_fields(buf):
        if f == 1:
            r.range_image = parse_matrix_float(v)
        elif f == 2:
            r.range_image_compressed = bytes(v)
        elif f == 3:
            r.camera_projection_compressed = bytes(v)
        elif f == 4:
            r.range_image_pose_compressed = bytes(v)
    return r


@dataclasses.dataclass
class Laser:
    name: int = 0
    ri_return1: RangeImage = None
    ri_return2: RangeImage = None


def _parse_laser(buf) -> Laser:
    l = Laser()
    for f, wt, v in iter_fields(buf):
        if f == 1:
            l.name = v
        elif f == 2:
            l.ri_return1 = _parse_range_image(v)
        elif f == 3:
            l.ri_return2 = _parse_range_image(v)
    return l


@dataclasses.dataclass
class Box:
    center_x: float = 0.0
    center_y: float = 0.0
    center_z: float = 0.0
    width: float = 0.0   # field 4 (dim y)
    length: float = 0.0  # field 5 (dim x)
    height: float = 0.0
    heading: float = 0.0


def _parse_box(buf) -> Box:
    b = Box()
    names = {1: "center_x", 2: "center_y", 3: "center_z", 4: "width",
             5: "length", 6: "height", 7: "heading"}
    for f, wt, v in iter_fields(buf):
        if f in names:
            setattr(b, names[f], _double(wt, v))
    return b


@dataclasses.dataclass
class LabelMetadata:
    speed_x: float = 0.0
    speed_y: float = 0.0
    accel_x: float = 0.0
    accel_y: float = 0.0


def _parse_metadata(buf) -> LabelMetadata:
    m = LabelMetadata()
    names = {1: "speed_x", 2: "speed_y", 3: "accel_x", 4: "accel_y"}
    for f, wt, v in iter_fields(buf):
        if f in names:
            setattr(m, names[f], _double(wt, v))
    return m


@dataclasses.dataclass
class Label:
    box: Box = None
    metadata: LabelMetadata = None
    type: int = 0
    id: str = ""


def _parse_label(buf) -> Label:
    l = Label(box=Box(), metadata=LabelMetadata())
    for f, wt, v in iter_fields(buf):
        if f == 1:
            l.box = _parse_box(v)
        elif f == 2:
            l.metadata = _parse_metadata(v)
        elif f == 3:
            l.type = v
        elif f == 4:
            l.id = bytes(v).decode("utf-8", "replace")
    return l


@dataclasses.dataclass
class Frame:
    context: Context = None
    timestamp_micros: int = 0
    pose: np.ndarray = None  # (4,4) vehicle->world
    images: list = dataclasses.field(default_factory=list)
    lasers: list = dataclasses.field(default_factory=list)
    laser_labels: list = dataclasses.field(default_factory=list)


def parse_frame(buf: bytes) -> Frame:
    fr = Frame(context=Context())
    for f, wt, v in iter_fields(buf):
        if f == 1:
            fr.context = _parse_context(v)
        elif f == 2:
            fr.timestamp_micros = v
        elif f == 3:
            fr.pose = _parse_transform(v)
        elif f == 4:
            fr.images.append(_parse_camera_image(v))
        elif f == 5:
            fr.lasers.append(_parse_laser(v))
        elif f == 6:
            fr.laser_labels.append(_parse_label(v))
    return fr
