"""SMILE binary JSON codec (decode + encode).

The coordinator's binary transport: HttpRemoteTask POSTs task updates
and reads TaskStatus/TaskInfo as `application/x-jackson-smile` when
binary transport is enabled (HttpRemoteTask.java:915-931 negotiation;
PrestoMediaTypes.APPLICATION_JACKSON_SMILE; airlift SmileCodec wraps
Jackson's SmileFactory).  This module implements the SMILE format
(https://github.com/FasterXML/smile-format-specification) for the JSON
value model the protocol uses: objects, arrays, strings, ints, doubles,
booleans, null — enough to decode every TaskUpdateRequest a coordinator
can send and encode every status/info response it reads back.

Layout essentials implemented here:
  header       ":)\\n" + options byte (bit0 shared keys, bit1 shared
               string values, bit2 raw binary)
  keys         0x20 empty; 0x30-0x33+byte long shared ref; 0x34 long
               unicode (0xFC-terminated); 0x40-0x7F short shared ref;
               0x80-0xBF short ASCII (len 1-64); 0xC0-0xF7 short Unicode
               (len 2-57); 0xFB END_OBJECT
  values       0x00-0x1F misc/shared-string refs; 0x20 ""; 0x21 null;
               0x22/0x23 false/true; 0x24/0x25 32/64-bit zigzag vints;
               0x26 BigInteger; 0x28/0x29 float/double (7-bit packed);
               0x2A BigDecimal; 0x40-0x5F tiny ASCII (1-32); 0x60-0x7F
               small ASCII (33-64); 0x80-0x9F tiny Unicode (2-33);
               0xA0-0xBF small Unicode (34-65); 0xC0-0xDF small ints
               (zigzag -16..15); 0xE0/0xE4 long ASCII/Unicode
               (0xFC-terminated); 0xE8 7-bit-packed binary; 0xF8/0xF9
               array start/end; 0xFA/0xFB object start/end
  vints        7 bits per byte; the FINAL byte has bit 7 set and carries
               the low 6 bits
Shared-name/value tables hold up to 1024 entries and reset on overflow,
matching Jackson's behavior.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

CONTENT_TYPE = "application/x-jackson-smile"

_HEADER = b":)\n"
_F_SHARED_NAMES = 0x01
_F_SHARED_VALUES = 0x02
_MAX_SHARED = 1024


class SmileError(ValueError):
    pass


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        if not buf.startswith(_HEADER) or len(buf) < 4:
            raise SmileError("not a SMILE document (missing :)\\n header)")
        self.buf = buf
        self.pos = 4
        opts = buf[3]
        self.shared_names = bool(opts & _F_SHARED_NAMES)
        self.shared_values = bool(opts & _F_SHARED_VALUES)
        self.names: List[str] = []
        self.values: List[str] = []

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise SmileError("truncated SMILE document")
        self.pos += n
        return out

    def vint(self) -> int:
        """Unsigned vint: 7 bits/byte, final byte has bit 7 set and
        carries 6 bits."""
        v = 0
        while True:
            b = self.byte()
            if b & 0x80:
                return (v << 6) | (b & 0x3F)
            v = (v << 7) | b

    def zigzag_vint(self) -> int:
        v = self.vint()
        return (v >> 1) ^ -(v & 1)

    def until_fc(self) -> bytes:
        end = self.buf.index(0xFC, self.pos)
        out = self.buf[self.pos:end]
        self.pos = end + 1
        return out

    def packed7(self, nbytes: int) -> int:
        """Big-endian 7-bits-per-byte packing used for float/double."""
        v = 0
        for _ in range(nbytes):
            v = (v << 7) | (self.byte() & 0x7F)
        return v

    def _share_name(self, s: str) -> str:
        if self.shared_names and len(s.encode()) <= 64:
            if len(self.names) >= _MAX_SHARED:
                self.names = []
            self.names.append(s)
        return s

    def _share_value(self, s: str) -> str:
        if self.shared_values and len(s.encode()) <= 64:
            if len(self.values) >= _MAX_SHARED:
                self.values = []
            self.values.append(s)
        return s

    # -- tokens ----------------------------------------------------------
    def key(self):
        t = self.byte()
        if t == 0xFB:
            return None                       # END_OBJECT
        if t == 0x20:
            return ""
        if 0x30 <= t <= 0x33:                 # long shared ref
            return self.names[((t & 0x03) << 8) | self.byte()]
        if t == 0x34:                         # long unicode name
            return self._share_name(self.until_fc().decode("utf-8"))
        if 0x40 <= t <= 0x7F:                 # short shared ref
            return self.names[t - 0x40]
        if 0x80 <= t <= 0xBF:                 # short ASCII, len 1-64
            return self._share_name(self.take(t - 0x80 + 1).decode("ascii"))
        if 0xC0 <= t <= 0xF7:                 # short Unicode, len 2-57
            return self._share_name(self.take(t - 0xC0 + 2).decode("utf-8"))
        raise SmileError(f"unknown key token {t:#x}")

    def value(self, t: int) -> Any:
        if 0x01 <= t <= 0x1F:                 # short shared value ref
            return self.values[t - 1]
        if 0x2C <= t <= 0x2F:                 # long shared value ref
            return self.values[((t & 0x03) << 8) | self.byte()]
        if t == 0x20:
            return ""
        if t == 0x21:
            return None
        if t == 0x22:
            return False
        if t == 0x23:
            return True
        if t in (0x24, 0x25):                 # 32/64-bit zigzag vint
            return self.zigzag_vint()
        if t == 0x26:                         # BigInteger
            n = self.vint()                   # ORIGINAL byte count
            raw = self.take(_packed7_len(n))
            return int.from_bytes(_unpack7(raw)[:n], "big", signed=True)
        if t == 0x28:                         # float (5 x 7 bits)
            bits = self.packed7(5) & 0xFFFFFFFF
            return struct.unpack(">f", struct.pack(">I", bits))[0]
        if t == 0x29:                         # double (10 x 7 bits)
            bits = self.packed7(10) & 0xFFFFFFFFFFFFFFFF
            return struct.unpack(">d", struct.pack(">Q", bits))[0]
        if t == 0x2A:                         # BigDecimal: scale + magn.
            scale = self.zigzag_vint()
            n = self.vint()                   # ORIGINAL byte count
            raw = self.take(_packed7_len(n))
            unscaled = int.from_bytes(_unpack7(raw)[:n], "big",
                                      signed=True)
            from decimal import Decimal
            return Decimal(unscaled).scaleb(-scale)
        if 0x40 <= t <= 0x5F:                 # tiny ASCII 1-32
            return self._share_value(self.take(t - 0x40 + 1).decode("ascii"))
        if 0x60 <= t <= 0x7F:                 # small ASCII 33-64
            return self._share_value(self.take(t - 0x60 + 33).decode("ascii"))
        if 0x80 <= t <= 0x9F:                 # tiny Unicode 2-33
            return self._share_value(self.take(t - 0x80 + 2).decode("utf-8"))
        if 0xA0 <= t <= 0xBF:                 # small Unicode 34-65
            return self._share_value(self.take(t - 0xA0 + 34).decode("utf-8"))
        if 0xC0 <= t <= 0xDF:                 # small int zigzag -16..15
            v = t - 0xC0
            return (v >> 1) ^ -(v & 1)
        if t == 0xE0:                         # long ASCII
            return self.until_fc().decode("ascii")
        if t == 0xE4:                         # long Unicode
            return self.until_fc().decode("utf-8")
        if t == 0xE8:                         # 7-bit packed binary
            n = self.vint()
            return _unpack7(self.take(_packed7_len(n)))[:n]
        if t == 0xF8:                         # array
            out = []
            while True:
                vt = self.byte()
                if vt == 0xF9:
                    return out
                out.append(self.value(vt))
        if t == 0xFA:                         # object
            obj = {}
            while True:
                k = self.key()
                if k is None:
                    return obj
                obj[k] = self.value(self.byte())
        raise SmileError(f"unknown value token {t:#x}")


def _packed7_len(n: int) -> int:
    """Packed byte count for n source bytes under the 7-bit packing."""
    full, rem = divmod(n, 7)
    return full * 8 + (rem + 1 if rem else 0)


def _unpack7(raw: bytes) -> bytes:
    """Inverse of SMILE's 7-bit byte packing, Jackson convention: 7
    source bytes per 8 packed bytes; a trailing group of n source bytes
    packs into n+1 bytes with the LAST packed byte carrying the low n
    bits right-aligned (SmileParser._read7BitBinaryWithLength: one
    trailing byte b arrives as [b>>1, b&0x01])."""
    out = bytearray()
    i = 0
    while i + 8 <= len(raw):
        v = 0
        for b in raw[i:i + 8]:
            v = (v << 7) | (b & 0x7F)
        out.extend(v.to_bytes(7, "big"))
        i += 8
    rem = len(raw) - i
    if rem > 1:
        n = rem - 1                      # decoded byte count
        v = 0
        for b in raw[i:i + n]:
            v = (v << 7) | (b & 0x7F)
        v = (v << n) | (raw[-1] & ((1 << n) - 1))
        out.extend(v.to_bytes(n, "big"))
    return bytes(out)


def decode(buf: bytes) -> Any:
    r = _Reader(buf)
    t = r.byte()
    return r.value(t)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self, shared_names: bool = True):
        self.out = bytearray(_HEADER)
        self.out.append(_F_SHARED_NAMES if shared_names else 0)
        self.shared_names = shared_names
        self.names: dict = {}

    def vint(self, v: int) -> None:
        """Unsigned vint (final byte: bit 7 set, low 6 bits)."""
        last = 0x80 | (v & 0x3F)
        v >>= 6
        rest = []
        while v:
            rest.append(v & 0x7F)
            v >>= 7
        self.out.extend(reversed(rest))
        self.out.append(last)

    def zigzag_vint(self, v: int) -> None:
        self.vint(v * 2 if v >= 0 else -v * 2 - 1)

    def packed7(self, v: int, nbytes: int) -> None:
        for i in reversed(range(nbytes)):
            self.out.append((v >> (7 * i)) & 0x7F)

    def key(self, k: str) -> None:
        if k == "":
            self.out.append(0x20)
            return
        if self.shared_names:
            ref = self.names.get(k)
            if ref is not None:
                if ref < 64:
                    self.out.append(0x40 + ref)
                else:
                    self.out.append(0x30 + (ref >> 8))
                    self.out.append(ref & 0xFF)
                return
        raw = k.encode("utf-8")
        if len(raw) <= 64 and raw.isascii():
            self.out.append(0x80 + len(raw) - 1)
            self.out.extend(raw)
        elif 2 <= len(raw) <= 57:
            self.out.append(0xC0 + len(raw) - 2)
            self.out.extend(raw)
        else:
            self.out.append(0x34)
            self.out.extend(raw)
            self.out.append(0xFC)
        if self.shared_names and len(raw) <= 64:
            if len(self.names) >= _MAX_SHARED:
                self.names = {}
            self.names[k] = len(self.names)

    def value(self, v: Any) -> None:
        if v is None:
            self.out.append(0x21)
        elif v is False:
            self.out.append(0x22)
        elif v is True:
            self.out.append(0x23)
        elif isinstance(v, int):
            if -16 <= v <= 15:
                self.out.append(0xC0 + (v * 2 if v >= 0 else -v * 2 - 1))
            elif -(1 << 63) <= v < (1 << 63):
                self.out.append(0x24 if -(1 << 31) <= v < (1 << 31)
                                else 0x25)
                self.zigzag_vint(v)
            else:
                mag = v.to_bytes((v.bit_length() + 8) // 8, "big",
                                 signed=True)
                self.out.append(0x26)
                self.vint(len(mag))          # ORIGINAL byte count
                self.out.extend(_pack7(mag))
        elif isinstance(v, float):
            bits = struct.unpack(">Q", struct.pack(">d", v))[0]
            self.out.append(0x29)
            self.packed7(bits, 10)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            if not raw:
                self.out.append(0x20)
            elif raw.isascii():
                if len(raw) <= 32:
                    self.out.append(0x40 + len(raw) - 1)
                    self.out.extend(raw)
                elif len(raw) <= 64:
                    self.out.append(0x60 + len(raw) - 33)
                    self.out.extend(raw)
                else:
                    self.out.append(0xE0)
                    self.out.extend(raw)
                    self.out.append(0xFC)
            else:
                if 2 <= len(raw) <= 33:
                    self.out.append(0x80 + len(raw) - 2)
                    self.out.extend(raw)
                elif 34 <= len(raw) <= 65:
                    self.out.append(0xA0 + len(raw) - 34)
                    self.out.extend(raw)
                else:
                    self.out.append(0xE4)
                    self.out.extend(raw)
                    self.out.append(0xFC)
        elif isinstance(v, (list, tuple)):
            self.out.append(0xF8)
            for item in v:
                self.value(item)
            self.out.append(0xF9)
        elif isinstance(v, dict):
            self.out.append(0xFA)
            for k, item in v.items():
                self.key(str(k))
                self.value(item)
            self.out.append(0xFB)
        else:
            from decimal import Decimal
            if isinstance(v, Decimal):
                sign, digits, exp = v.as_tuple()
                unscaled = int(v.scaleb(-exp)) if exp <= 0 else int(v)
                scale = max(-exp, 0)
                mag = unscaled.to_bytes(
                    (unscaled.bit_length() + 8) // 8, "big", signed=True)
                self.out.append(0x2A)
                self.zigzag_vint(scale)
                self.vint(len(mag))          # ORIGINAL byte count
                self.out.extend(_pack7(mag))
            else:
                raise SmileError(f"cannot encode {type(v).__name__}")


def _pack7(raw: bytes) -> bytes:
    """SMILE 7-bit byte packing, Jackson convention: 7 source bytes -> 8
    packed bytes; a trailing group of n bytes -> n+1 packed bytes with
    the last byte carrying the low n bits right-aligned
    (SmileGenerator._write7BitBinaryWithLength)."""
    out = bytearray()
    i = 0
    while i + 7 <= len(raw):
        v = int.from_bytes(raw[i:i + 7], "big")
        for j in reversed(range(8)):
            out.append((v >> (7 * j)) & 0x7F)
        i += 7
    rem = len(raw) - i
    if rem:
        v = int.from_bytes(raw[i:], "big")       # 8*rem bits
        for j in reversed(range(rem)):
            out.append((v >> (rem + 7 * j)) & 0x7F)
        out.append(v & ((1 << rem) - 1))
    return bytes(out)


def encode(obj: Any, shared_names: bool = True) -> bytes:
    w = _Writer(shared_names=shared_names)
    w.value(obj)
    return bytes(w.out)
