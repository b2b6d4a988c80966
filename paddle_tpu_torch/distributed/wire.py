"""Typed, non-executable wire protocol: length-prefixed frames with an
optional HMAC.

Counterpart of ``paddle_tpu/distributed/wire.py``. Value universe: None,
bool, int, float, str, numeric numpy arrays, and tuples/lists/dicts of
those — decoded by a small recursive reader that can only ever produce
data (no pickle).

Frame layout:
    magic  b"PT01"                       (4 bytes)
    mac    HMAC-SHA256(key, payload)     (32 bytes; zeros when no key)
    len    big-endian u64                (8 bytes)
    payload                              (typed encoding)

Set ``PADDLE_PS_AUTH_KEY`` (or pass ``key=``) on both ends to make a
receiver reject frames whose MAC does not verify.
"""
import hashlib
import hmac
import os
import struct

import numpy as np

MAGIC = b"PT01"
MAC_LEN = 32
MAX_FRAME = 2 << 30            # a hostile length prefix cannot go past
_ALLOWED_KINDS = frozenset("biufc")
_MAX_DEPTH = 32


class WireError(ValueError):
    pass


class WireTruncationError(WireError, ConnectionError):
    """The peer closed mid-frame (also a ConnectionError, so transport
    handlers treat it as a broken link)."""

    def __init__(self, endpoint=None, expected=None, received=None,
                 context="frame"):
        self.endpoint = endpoint
        self.expected = expected
        self.received = received
        super().__init__(
            f"connection to {endpoint or 'peer'} closed mid-{context}: "
            f"expected {expected} bytes, received {received}")


def _peer(sock):
    try:
        host, port = sock.getpeername()[:2]
        return f"{host}:{port}"
    except OSError:
        return None


def default_key():
    k = os.environ.get("PADDLE_PS_AUTH_KEY", "")
    return k.encode() if k else None


# ----------------------------------------------------------------- encode

def _enc_str(out, s):
    b = s.encode("utf-8")
    out.append(struct.pack(">I", len(b)))
    out.append(b)


def _encode(out, v):
    if v is None:
        out.append(b"N")
    elif v is True:
        out.append(b"t")
    elif v is False:
        out.append(b"f")
    elif isinstance(v, (int, np.integer)):
        i = int(v)
        if not -(2 ** 63) <= i < 2 ** 63:
            raise WireError(f"int {i} outside the wire's 64-bit range")
        out.append(struct.pack(">Bq", ord("I"), i))
    elif isinstance(v, (float, np.floating)):
        out.append(struct.pack(">Bd", ord("F"), float(v)))
    elif isinstance(v, str):
        out.append(b"S")
        _enc_str(out, v)
    elif isinstance(v, np.ndarray):
        if v.dtype.kind not in _ALLOWED_KINDS:
            raise WireError(f"non-numeric array dtype {v.dtype} refused")
        buf = np.ascontiguousarray(v).tobytes()
        out.append(struct.pack(">B", ord("A")))
        _enc_str(out, v.dtype.str)
        out.append(struct.pack(">B", v.ndim))
        out.append(struct.pack(f">{v.ndim}q", *v.shape))
        out.append(struct.pack(">Q", len(buf)))
        out.append(buf)
    elif isinstance(v, (tuple, list)):
        out.append(struct.pack(">BI", ord("T"), len(v)))
        for item in v:
            _encode(out, item)
    elif isinstance(v, dict):
        out.append(struct.pack(">BI", ord("D"), len(v)))
        for k, item in v.items():
            if not isinstance(k, str):
                raise WireError(f"dict keys must be str, got {type(k)}")
            _enc_str(out, k)
            _encode(out, item)
    else:
        raise WireError(f"type {type(v).__name__} is not wire-encodable")


def encode(v):
    out = []
    _encode(out, v)
    return b"".join(out)


# ----------------------------------------------------------------- decode

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0
        self.depth = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise WireError("truncated frame")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _dec_str(r):
    (n,) = r.unpack(">I")
    return r.take(n).decode("utf-8")


def _dec_array(r):
    try:
        dt = np.dtype(_dec_str(r))
    except TypeError as e:
        raise WireError(f"bad dtype string: {e}")
    if dt.kind not in _ALLOWED_KINDS:
        raise WireError(f"non-numeric array dtype {dt} refused")
    (ndim,) = r.unpack(">B")
    shape = r.unpack(f">{ndim}q") if ndim else ()
    (nbytes,) = r.unpack(">Q")
    n_expect = dt.itemsize
    for d in shape:
        if d < 0:
            raise WireError(f"negative array dim {d}")
        n_expect *= d
    if nbytes != n_expect or nbytes > MAX_FRAME:
        raise WireError(f"array byte count {nbytes} != shape/dtype "
                        f"{n_expect}")
    return np.frombuffer(r.take(nbytes), dtype=dt).reshape(shape).copy()


def _decode(r):
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"t":
        return True
    if tag == b"f":
        return False
    if tag == b"I":
        return r.unpack(">q")[0]
    if tag == b"F":
        return r.unpack(">d")[0]
    if tag == b"S":
        return _dec_str(r)
    if tag == b"A":
        return _dec_array(r)
    if tag in (b"T", b"D"):
        (n,) = r.unpack(">I")
        r.depth += 1
        if r.depth > _MAX_DEPTH:
            raise WireError("nesting too deep")
        if tag == b"T":
            v = tuple(_decode(r) for _ in range(n))
        else:
            v = {_dec_str(r): _decode(r) for _ in range(n)}
        r.depth -= 1
        return v
    raise WireError(f"unknown wire tag {tag!r}")


def decode(buf):
    r = _Reader(buf)
    try:
        v = _decode(r)
    except WireError:
        raise
    except Exception as e:
        # the contract is "data or WireError"
        raise WireError(f"malformed frame: {type(e).__name__}: {e}")
    if r.pos != len(buf):
        raise WireError("trailing bytes after value")
    return v


# ------------------------------------------------------------------ frame

def _recv_exact(sock, n, context="frame"):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireTruncationError(endpoint=_peer(sock), expected=n,
                                      received=len(buf), context=context)
        buf += chunk
    return bytes(buf)


def send_frame(sock, obj, key=None, timeout=None):
    if timeout is not None:
        sock.settimeout(timeout)
    payload = encode(obj)
    mac = hmac.new(key, payload, hashlib.sha256).digest() if key \
        else b"\x00" * MAC_LEN
    sock.sendall(MAGIC + mac + struct.pack(">Q", len(payload)) + payload)


def recv_frame(sock, key=None, timeout=None):
    if timeout is not None:
        sock.settimeout(timeout)
    head = _recv_exact(sock, len(MAGIC) + MAC_LEN + 8, context="header")
    if head[:len(MAGIC)] != MAGIC:
        raise WireError("bad magic — not a paddle_tpu frame")
    mac = head[len(MAGIC):len(MAGIC) + MAC_LEN]
    (n,) = struct.unpack(">Q", head[len(MAGIC) + MAC_LEN:])
    if n > MAX_FRAME:
        raise WireError(f"frame of {n} bytes exceeds cap {MAX_FRAME}")
    payload = _recv_exact(sock, n, context="payload")
    if key is not None:
        want = hmac.new(key, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(mac, want):
            raise WireError("HMAC verification failed — unauthenticated "
                            "frame rejected")
    return decode(payload)
