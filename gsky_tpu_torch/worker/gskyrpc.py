"""The worker RPC's messages, encoded as protobuf encodes them.

Counterpart of `gsky_tpu/worker/gskyrpc_pb2.py`, written in plain
Python because the port does not depend on ``protobuf``: the eight
messages of ``gskyrpc.proto`` (`Granule`, `DstSpec`, `DrillSpec`,
`Task`, `TimeSeries`, `WorkerInfo`, `Metrics`, `Result`) with the same
names, fields and numbers, and the part of the generated API the call
sites use: keyword construction, attribute access, `SerializeToString`,
`FromString` / `ParseFromString`, `CopyFrom`, `Clear`, `HasField`
(message fields), list-like repeated fields
(``append``, ``extend``, ``del x[:]``) and submessages created on first
access.

The bytes equal protobuf's (proto3, as ``upb`` writes them):

- fields go out in field-number order;
- a scalar at its default (0, 0.0, False, "", b"") is left out; a
  double is left out only when its bits are zero, so -0.0 and NaN are
  written;
- repeated numeric fields are packed, an empty one is left out;
- ``int32`` and ``int64`` are varints, a negative one ten bytes long;
  ``double`` is fixed64, little-endian; ``bool`` a one-byte varint;
- a submessage is written once it has been set or touched, even when it
  is empty: ``CopyFrom``, an assignment to one of its fields (a default
  value too), or a change to one of its repeated fields
  (``extend([])`` and ``del x[:]`` included).  Reading its fields does
  not touch it.

Parsing takes packed and unpacked repeated numerics alike, merges a
submessage that appears twice, keeps the last of a repeated scalar, and
skips unknown fields (and known fields of the wrong wire type, as
protobuf does).  Malformed input raises `DecodeError`.
"""

from __future__ import annotations

import operator
import struct
from typing import Dict, Iterable, List, Optional, Tuple

_U64 = (1 << 64) - 1
_WT_VARINT, _WT_I64, _WT_LEN, _WT_SGROUP, _WT_EGROUP, _WT_I32 = \
    0, 1, 2, 3, 4, 5
# the wire type of each scalar kind
_WIRE = {"int32": _WT_VARINT, "int64": _WT_VARINT, "bool": _WT_VARINT,
         "double": _WT_I64, "string": _WT_LEN, "bytes": _WT_LEN,
         "message": _WT_LEN}
_DEFAULT = {"int32": 0, "int64": 0, "bool": False, "double": 0.0,
            "string": "", "bytes": b""}
_RANGE = {"int32": (-(1 << 31), (1 << 31) - 1),
          "int64": (-(1 << 63), (1 << 63) - 1)}
_ZERO8 = b"\x00" * 8


class DecodeError(Exception):
    """The bytes are not a valid encoding of the message."""


# -- wire primitives --------------------------------------------------------


def _put_varint(out: bytearray, v: int) -> None:
    v &= _U64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _signed(v: int, kind: str) -> int:
    if kind == "int32":
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    return v - (1 << 64) if v >= 1 << 63 else v


def _skip(buf, pos: int, wt: int, num: int) -> int:
    """Position after an unknown field's value."""
    if wt == _WT_VARINT:
        return _get_varint(buf, pos)[1]
    if wt == _WT_I64:
        pos += 8
    elif wt == _WT_I32:
        pos += 4
    elif wt == _WT_LEN:
        n, pos = _get_varint(buf, pos)
        pos += n
    elif wt == _WT_SGROUP:
        while True:
            key, pos = _get_varint(buf, pos)
            if key & 7 == _WT_EGROUP:
                if key >> 3 != num:
                    raise DecodeError("mismatched end group")
                return pos
            pos = _skip(buf, pos, key & 7, key >> 3)
    else:
        raise DecodeError(f"bad wire type {wt}")
    if pos > len(buf):
        raise DecodeError("truncated field")
    return pos


# -- fields -------------------------------------------------------------------


class _Field:
    __slots__ = ("name", "number", "kind", "repeated", "msg", "key")

    def __init__(self, name: str, number: int, kind: str,
                 repeated: bool = False, msg: Optional[type] = None):
        self.name = name
        self.number = number
        self.kind = kind
        self.repeated = repeated
        self.msg = msg
        wt = _WT_LEN if repeated else _WIRE[kind]
        self.key = bytes(_varint_bytes((number << 3) | wt))

    def check(self, v):
        """``v`` as this scalar kind stores it; TypeError or ValueError
        as protobuf raises them."""
        kind = self.kind
        if kind == "double":
            if isinstance(v, (str, bytes)) or v is None:
                raise TypeError(f"{v!r} has type {type(v).__name__}, but "
                                f"expected one of: int, float")
            return float(v)
        if kind in ("int32", "int64"):
            if isinstance(v, float) or v is None:
                raise TypeError(f"{v!r} has type {type(v).__name__}, but "
                                f"expected one of: int")
            v = operator.index(v)
            lo, hi = _RANGE[kind]
            if not lo <= v <= hi:
                raise ValueError(f"Value out of range: {v}")
            return int(v)
        if kind == "bool":
            if isinstance(v, (str, bytes, float)) or v is None:
                raise TypeError(f"{v!r} has type {type(v).__name__}, but "
                                f"expected one of: int, bool")
            return bool(v)
        if kind == "string":
            if isinstance(v, (bytes, bytearray)):
                return bytes(v).decode("utf-8")
            if not isinstance(v, str):
                raise TypeError(f"{v!r} has type {type(v).__name__}, but "
                                f"expected one of: bytes, str")
            return v
        if kind == "bytes":
            if isinstance(v, (bytes, bytearray, memoryview)):
                return bytes(v)
            raise TypeError(f"{v!r} has type {type(v).__name__}, but "
                            f"expected one of: bytes")
        raise TypeError(f"field {self.name} is not a scalar")


def _varint_bytes(v: int) -> bytearray:
    out = bytearray()
    _put_varint(out, v)
    return out


class _Repeated(list):
    """A repeated field: a list that checks what goes in and touches its
    message on every change."""

    __slots__ = ("_owner", "_field")

    def __init__(self, owner: "Message", field: _Field,
                 items: Iterable = ()):
        super().__init__(field.check(v) for v in items)
        self._owner = owner
        self._field = field

    def _touch(self) -> None:
        self._owner._reify()

    def append(self, v) -> None:
        super().append(self._field.check(v))
        self._touch()

    def extend(self, vs) -> None:
        super().extend([self._field.check(v) for v in vs])
        self._touch()

    def insert(self, i, v) -> None:
        super().insert(i, self._field.check(v))
        self._touch()

    def __setitem__(self, i, v) -> None:
        if isinstance(i, slice):
            v = [self._field.check(x) for x in v]
        else:
            v = self._field.check(v)
        super().__setitem__(i, v)
        self._touch()

    def __delitem__(self, i) -> None:
        super().__delitem__(i)
        self._touch()

    def __iadd__(self, vs):
        self.extend(vs)
        return self

    def pop(self, i=-1):
        v = super().pop(i)
        self._touch()
        return v

    def remove(self, v) -> None:
        super().remove(v)
        self._touch()

    def clear(self) -> None:
        super().clear()
        self._touch()



# -- messages ---------------------------------------------------------------


class Message:
    """A proto3 message.  Subclasses list their fields in ``_SPEC`` as
    (name, number, kind[, repeated][, message class name])."""

    __slots__ = ("_v", "_has", "_parent")
    _FIELDS: Tuple[_Field, ...] = ()
    _BY_NAME: Dict[str, _Field] = {}
    _BY_NUM: Dict[int, _Field] = {}

    def __init__(self, **kwargs):
        object.__setattr__(self, "_v", {})
        object.__setattr__(self, "_has", set())
        object.__setattr__(self, "_parent", None)
        for name, value in kwargs.items():
            f = self._BY_NAME.get(name)
            if f is None:
                raise ValueError(f'Protocol message {type(self).__name__} '
                                 f'has no "{name}" field.')
            if value is None:
                continue
            if f.repeated:
                getattr(self, name).extend(value)
            elif f.kind == "message":
                sub = getattr(self, name)
                if isinstance(value, dict):
                    sub.CopyFrom(f.msg(**value))
                else:
                    sub.CopyFrom(value)
            else:
                setattr(self, name, value)

    # -- attribute access --------------------------------------------------

    def __getattr__(self, name: str):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(name)
        v = self._v.get(name)
        if v is not None:
            return v
        if f.repeated:
            v = self._v[name] = _Repeated(self, f)
            return v
        if f.kind == "message":
            # a stub: present in the parent only once it is touched
            v = f.msg()
            object.__setattr__(v, "_parent", (self, name))
            self._v[name] = v
            return v
        return _DEFAULT[f.kind]

    def __setattr__(self, name: str, value) -> None:
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"Protocol message {type(self).__name__} has no field "
                f"{name!r}")
        if f.repeated or f.kind == "message":
            raise AttributeError(
                f"Assignment not allowed to composite field \"{name}\" in "
                f"protocol message object.")
        self._v[name] = f.check(value)
        self._reify()

    def _reify(self) -> None:
        """Mark this message present in its parent (and the parent in
        its own), as a change to a submessage does."""
        p = self._parent
        while p is not None:
            parent, name = p
            if name in parent._has:
                return
            parent._has.add(name)
            p = parent._parent

    # -- the generated API ---------------------------------------------------

    def HasField(self, name: str) -> bool:
        f = type(self)._BY_NAME.get(name)
        if f is None or f.repeated or f.kind != "message":
            raise ValueError(f'Protocol message {type(self).__name__} has '
                             f'no singular message field "{name}".')
        return name in self._has

    def Clear(self) -> None:
        self._v.clear()
        self._has.clear()

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"Parameter to CopyFrom() must be instance of "
                            f"same class: expected {type(self).__name__} "
                            f"got {type(other).__name__}.")
        if other is self:
            self._reify()
            return
        self.Clear()
        self._merge(other)
        self._reify()

    def _merge(self, other: "Message") -> None:
        for f in self._FIELDS:
            v = other._v.get(f.name)
            if f.repeated:
                if v:
                    list.extend(getattr(self, f.name), v)
            elif f.kind == "message":
                if f.name in other._has:
                    sub = getattr(self, f.name)
                    sub._merge(v)
                    self._has.add(f.name)
            elif v is not None and _nondefault(f.kind, v):
                self._v[f.name] = v

    def SerializeToString(self, **_kw) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def _encode(self, out: bytearray) -> None:
        v_of = self._v
        for f in self._FIELDS:
            v = v_of.get(f.name)
            if f.repeated:
                if v:
                    out += f.key
                    payload = _pack(f.kind, v)
                    _put_varint(out, len(payload))
                    out += payload
                continue
            if f.kind == "message":
                if f.name in self._has:
                    sub = bytearray()
                    v._encode(sub)
                    out += f.key
                    _put_varint(out, len(sub))
                    out += sub
                continue
            if v is None or not _nondefault(f.kind, v):
                continue
            out += f.key
            kind = f.kind
            if kind == "double":
                out += struct.pack("<d", v)
            elif kind in ("int32", "int64", "bool"):
                _put_varint(out, int(v))
            else:
                data = v.encode("utf-8") if kind == "string" else v
                _put_varint(out, len(data))
                out += data

    @classmethod
    def FromString(cls, data) -> "Message":
        m = cls()
        m.ParseFromString(data)
        return m

    def ParseFromString(self, data) -> int:
        """Replace this message with the one ``data`` encodes; returns
        the bytes read."""
        self.Clear()
        buf = memoryview(data).cast("B") if not isinstance(
            data, (bytes, bytearray)) else data
        self._decode(buf, 0, len(buf))
        self._reify()
        return len(buf)

    def _decode(self, buf, pos: int, end: int) -> None:
        by_num = self._BY_NUM
        v_of = self._v
        while pos < end:
            key, pos = _get_varint(buf, pos)
            num, wt = key >> 3, key & 7
            if num == 0:
                raise DecodeError("field number 0")
            f = by_num.get(num)
            if f is None:
                pos = _skip(buf, pos, wt, num)
                continue
            if f.repeated:
                if wt == _WT_LEN:
                    n, pos = _get_varint(buf, pos)
                    if pos + n > end:
                        raise DecodeError("truncated packed field")
                    list.extend(getattr(self, f.name),
                                _unpack(f.kind, buf, pos, pos + n))
                    pos += n
                elif wt == _WIRE[f.kind]:
                    v, pos = _read_scalar(f.kind, buf, pos, end)
                    list.append(getattr(self, f.name), v)
                else:
                    pos = _skip(buf, pos, wt, num)
                continue
            if wt != _WIRE[f.kind]:
                pos = _skip(buf, pos, wt, num)
                continue
            if f.kind == "message":
                n, pos = _get_varint(buf, pos)
                if pos + n > end:
                    raise DecodeError("truncated submessage")
                sub = getattr(self, f.name)
                sub._decode(buf, pos, pos + n)
                self._has.add(f.name)
                pos += n
                continue
            v, pos = _read_scalar(f.kind, buf, pos, end)
            v_of[f.name] = v
        if pos != end:
            raise DecodeError("field runs past the end of its message")

    # -- comparisons and display ---------------------------------------------

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None

    def __repr__(self) -> str:
        parts = []
        for f in self._FIELDS:
            v = self._v.get(f.name)
            if f.repeated:
                if v:
                    parts.append(f"{f.name}={list(v)!r}")
            elif f.kind == "message":
                if f.name in self._has:
                    parts.append(f"{f.name}={v!r}")
            elif v is not None and _nondefault(f.kind, v):
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _nondefault(kind: str, v) -> bool:
    if kind == "double":
        return struct.pack("<d", v) != _ZERO8
    return bool(v)


def _pack(kind: str, vals: List) -> bytes:
    if kind == "double":
        return struct.pack(f"<{len(vals)}d", *vals)
    out = bytearray()
    for v in vals:
        _put_varint(out, int(v))
    return bytes(out)


def _unpack(kind: str, buf, pos: int, end: int) -> List:
    if kind == "double":
        n = end - pos
        if n % 8:
            raise DecodeError("packed doubles of a partial width")
        return list(struct.unpack_from(f"<{n // 8}d", buf, pos))
    out = []
    while pos < end:
        v, pos = _get_varint(buf, pos)
        out.append(_scalar_of(kind, v))
    if pos != end:
        raise DecodeError("packed varints run past their field")
    return out


def _scalar_of(kind: str, v: int):
    if kind == "bool":
        return v != 0
    return _signed(v, kind)


def _read_scalar(kind: str, buf, pos: int, end: int):
    if kind == "double":
        if pos + 8 > end:
            raise DecodeError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if kind in ("int32", "int64", "bool"):
        v, pos = _get_varint(buf, pos)
        return _scalar_of(kind, v), pos
    n, pos = _get_varint(buf, pos)
    if pos + n > end:
        raise DecodeError("truncated length-delimited field")
    raw = bytes(buf[pos:pos + n])
    if kind == "string":
        try:
            return raw.decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid UTF-8 in a string field: {e}")
    return raw, pos + n


def _build(cls, spec) -> None:
    fields = []
    for entry in spec:
        name, number, kind = entry[:3]
        repeated = len(entry) > 3 and entry[3] == "repeated"
        msg = globals()[entry[3]] if kind == "message" else None
        fields.append(_Field(name, number, kind, repeated, msg))
    fields.sort(key=lambda f: f.number)
    cls._FIELDS = tuple(fields)
    cls._BY_NAME = {f.name: f for f in fields}
    cls._BY_NUM = {f.number: f for f in fields}


class Granule(Message):
    __slots__ = ()


class DstSpec(Message):
    __slots__ = ()


class DrillSpec(Message):
    __slots__ = ()


class Task(Message):
    __slots__ = ()


class TimeSeries(Message):
    __slots__ = ()


class WorkerInfo(Message):
    __slots__ = ()


class Metrics(Message):
    __slots__ = ()


class Result(Message):
    __slots__ = ()


_build(Granule, [
    ("path", 1, "string"), ("ds_name", 2, "string"),
    ("var_name", 3, "string"), ("band", 4, "int32"),
    ("time_index", 5, "int32"), ("timestamp", 6, "double"),
    ("srs", 7, "string"), ("geo_transform", 8, "double", "repeated"),
    ("nodata", 9, "double"), ("has_nodata", 10, "bool"),
    ("array_type", 11, "string"), ("is_netcdf", 12, "bool"),
    ("namespace", 13, "string"), ("base_namespace", 14, "string"),
    ("geo_loc_json", 15, "string"), ("polygon", 16, "string")])
_build(DstSpec, [
    ("srs", 1, "string"), ("geo_transform", 2, "double", "repeated"),
    ("width", 3, "int32"), ("height", 4, "int32"),
    ("resample", 5, "string")])
_build(DrillSpec, [
    ("geometry_wkt", 1, "string"),
    ("time_indices", 2, "int32", "repeated"), ("stride", 3, "int32"),
    ("deciles", 4, "bool"), ("pixel_count", 5, "bool"),
    ("clip_upper", 6, "double"), ("clip_lower", 7, "double"),
    ("has_clip", 8, "bool"), ("vrt_xml", 9, "string")])
_build(Task, [
    ("operation", 1, "string"), ("granule", 2, "message", "Granule"),
    ("dst", 3, "message", "DstSpec"), ("drill", 4, "message", "DrillSpec"),
    ("path", 5, "string"), ("timeout_s", 6, "double")])
_build(TimeSeries, [
    ("means", 1, "double", "repeated"), ("counts", 2, "int32", "repeated"),
    ("deciles", 3, "double", "repeated")])
_build(WorkerInfo, [
    ("pool_size", 1, "int32"), ("queue_cap", 2, "int32"),
    ("platform", 3, "string")])
_build(Metrics, [
    ("bytes_read", 1, "int64"), ("user_time", 2, "double"),
    ("sys_time", 3, "double")])
_build(Result, [
    ("error", 1, "string"), ("raster", 2, "bytes"), ("valid", 3, "bytes"),
    ("shape", 4, "int32", "repeated"), ("bbox", 5, "double", "repeated"),
    ("window_gt", 6, "double", "repeated"), ("src_srs", 7, "string"),
    ("nodata", 8, "double"), ("dtype", 9, "string"),
    ("extent_width", 10, "int32"), ("extent_height", 11, "int32"),
    ("series", 12, "message", "TimeSeries"), ("info_json", 13, "string"),
    ("worker", 14, "message", "WorkerInfo"),
    ("metrics", 15, "message", "Metrics")])

MESSAGES = (Granule, DstSpec, DrillSpec, Task, TimeSeries, WorkerInfo,
            Metrics, Result)

__all__ = ["DecodeError", "Message", "MESSAGES"] + [
    m.__name__ for m in MESSAGES]
