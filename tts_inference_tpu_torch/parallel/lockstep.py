"""Lockstep serving across processes: one scheduler, every rank replays.

Port of ``tts_inference_tpu/parallel/lockstep.py``. A sharded engine is
several processes (one per device, ``parallel/mesh.py``), and every rank
must make the same collective calls in the same order. The scheduler's
device-entering surface is small (``MIRRORED``) and always driven from the
one scheduler thread, so process 0 owns the scheduler and the API and wraps
its EngineCore in :class:`MirroredCore`: each call is pickled (length-
prefixed) to every follower over a TCP side channel *before* it runs
locally; followers replay it against their own EngineCore, built over the
same shards of the same weights, in :func:`follower_loop`. This is the one
way the port runs a mesh of more than one device (``cli serve --tp/--dp``);
the JAX package needs it only across hosts.

Device tensors cross the channel as **handles**, never bytes: both sides
register every tensor a mirrored call returns under the same sequential id,
so when the scheduler chains a launch's ``last_tok``/``active`` into the
next call, the descriptor carries ``_Ref(id)`` and each process substitutes
its own twin (the launches return fresh clones, so ``id()`` keys with
strong references in the window hold). Host operands (prompts, seeds,
sampling knobs) go by value: they are identical by construction. A tensor
operand that is no mirrored output goes by value too, memoized by
``(id(t), t._version)``: the JAX package keyed its memo on identity
because jax arrays are immutable, but a torch tensor rewritten in place
keeps its id and bumps its version, so a key on identity alone would
replay a stale value on the followers.

The vocoder, the metrics and the API stay local to process 0: every
launch returns the whole batch's token rows on every rank, so process 0
holds them on its own device, and its fused admission vocode — outside the
mirrored calls — stays on.

A lost follower is fatal and sticky (:class:`LockstepPeerLost`): the mesh
can never complete another collective, so the scheduler fails every stream
and the server exits nonzero for a supervisor to restart the group.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import os
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import torch

_HDR = struct.Struct(">Q")
_STOP = "__stop__"
_PING = "__ping__"      # liveness probe — followers ignore it
_MAGIC = b"TTSLSv1\x00"
_HELLO = struct.Struct(">8sI32s")   # magic | process_id | hmac(token)

# SECURITY: the side channel carries pickled call descriptors (arbitrary
# code execution on loads) and user prompt text. The handshake keeps
# strangers out of follower slots and rejects coordinators that do not hold
# the shared token (TTS_LOCKSTEP_TOKEN), but the payloads are NOT
# encrypted: keep the channel on a trusted private network and bind it to
# the cluster-internal interface (--lockstep-bind), never a public one.


def _token() -> bytes:
    return os.environ.get("TTS_LOCKSTEP_TOKEN", "").encode()


def _hello_mac(token: bytes, process_id: int) -> bytes:
    return hmac.new(token or b"\x00", _MAGIC + struct.pack(">I", process_id),
                    hashlib.sha256).digest()


def _ack_mac(token: bytes) -> bytes:
    return hmac.new(token or b"\x00", _MAGIC + b"ack",
                    hashlib.sha256).digest()


class LockstepPeerLost(RuntimeError):
    """A follower channel died: the mesh is no longer whole, so no further
    collective can complete. Fatal by design: the scheduler fails every
    live request with a clean error and the server exits nonzero."""

    lockstep_fatal = True   # read by Scheduler.run_forever (engine/ does
    #                         not import parallel/lockstep)


# every EngineCore method that enters the device or changes host state the
# later launches depend on (the block allocator, the length bounds, the
# prefix map); the preemption trio: the snapshot gathers over dp, restore
# and preempt change the sampling state and the allocator
MIRRORED = (
    "warmup_graphs",
    "prefill_decode_launch",
    "decode_steps_launch",
    "decode_steps",
    "prefill_slots",
    "reset_slots",
    "reset_and_seed",
    "seed_slots",
    "_free_slot_blocks",
    "snapshot_slot",
    "restore_slot",
    "preempt_slot",
)


class _Ref:
    """Wire marker: 'use your own output registered under handle id'."""

    __slots__ = ("hid",)

    def __init__(self, hid: int):
        self.hid = hid


class _TensorVal:
    """Wire marker: a tensor operand by value (numpy, or a CPU tensor for
    dtypes numpy lacks) and whether it lived on a device; the follower
    rebuilds it on its own device."""

    __slots__ = ("val", "on_device")

    def __init__(self, val, on_device: bool):
        self.val = val
        self.on_device = on_device

    def tensor(self, device) -> torch.Tensor:
        t = self.val if isinstance(self.val, torch.Tensor) \
            else torch.from_numpy(self.val)
        return t.to(device) if self.on_device else t


def _leaves(obj):
    """The tensors of a result, in a fixed walk order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)


def _map(fn, obj, leaf=lambda x: isinstance(x, torch.Tensor)):
    if leaf(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v, leaf) for k, v in obj.items()}
    if hasattr(obj, "_fields"):
        return type(obj)(*(_map(fn, v, leaf) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v, leaf) for v in obj)
    return obj


class _HandleTable:
    """Sequentially-numbered registry of mirrored-call outputs.

    Both sides run the same registration walk after each call, so handle
    ids line up without negotiation. Bounded: the scheduler only chains
    recent outputs (the 2-deep pipeline)."""

    def __init__(self, window: int = 256):
        self._by_hid: deque = deque(maxlen=window)   # (hid, tensor)
        self._hid_of: dict = {}                       # id(tensor) -> hid
        self._arr_of: dict = {}                       # hid -> tensor
        self._next = 0
        # by-value memo of repeated operands, keyed (id, version); the
        # deque's strong references keep the ids from being reused
        self._val_cache: deque = deque(maxlen=window)  # (key, tensor)
        self._wire_of: dict = {}                       # key -> _TensorVal

    def register_outputs(self, out) -> None:
        for leaf in _leaves(out):
            hid = self._next
            self._next += 1
            if len(self._by_hid) == self._by_hid.maxlen:
                old_hid, old = self._by_hid[0]
                self._hid_of.pop(id(old), None)
                self._arr_of.pop(old_hid, None)
            self._by_hid.append((hid, leaf))
            self._hid_of[id(leaf)] = hid
            self._arr_of[hid] = leaf

    def hid_for(self, t) -> Optional[int]:
        return self._hid_of.get(id(t))

    def lookup(self, hid: int):
        return self._arr_of[hid]

    def wire_val(self, t) -> Optional[_TensorVal]:
        return self._wire_of.get((id(t), t._version))

    def cache_wire_val(self, t, wire: _TensorVal) -> None:
        if len(self._val_cache) == self._val_cache.maxlen:
            old_key, _old = self._val_cache[0]
            self._wire_of.pop(old_key, None)
        key = (id(t), t._version)
        self._val_cache.append((key, t))
        self._wire_of[key] = wire


def _encode(table: _HandleTable, obj):
    """obj with tensor leaves replaced by _Ref (mirrored outputs) or
    _TensorVal (host-built operands, memoized)."""
    def enc(x):
        hid = table.hid_for(x)
        if hid is not None:
            return _Ref(hid)
        cached = table.wire_val(x)
        if cached is not None:
            return cached
        host = x.detach().cpu()
        val = host if host.dtype == torch.bfloat16 else host.numpy().copy()
        wire = _TensorVal(val, x.device.type != "cpu")
        table.cache_wire_val(x, wire)
        return wire

    return _map(enc, obj)


def _decode(table: _HandleTable, obj, device="cpu"):
    def dec(x):
        if isinstance(x, _Ref):
            return table.lookup(x.hid)
        return x.tensor(device)

    return _map(dec, obj, leaf=lambda x: isinstance(x, (_Ref, _TensorVal)))


def _send(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv(sock: socket.socket) -> bytes:
    buf = io.BytesIO()
    need = _HDR.size
    while need:
        chunk = sock.recv(need)
        if not chunk:
            raise ConnectionError("lockstep channel closed")
        buf.write(chunk)
        need -= len(chunk)
    (n,) = _HDR.unpack(buf.getvalue())
    out = io.BytesIO()
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("lockstep channel closed mid-message")
        out.write(chunk)
        n -= len(chunk)
    return out.getvalue()


class MirroredCore:
    """EngineCore proxy for the coordinator (process 0).

    Mirrored methods send a descriptor to every follower, then run locally;
    everything else passes straight through. One lock serializes [send →
    local launch], so a follower's replay order is the local order."""

    def __init__(self, core, follower_socks: Sequence[socket.socket]):
        self._core = core
        self._socks = list(follower_socks)
        self._table = _HandleTable()
        self._lock = threading.Lock()
        self.peer_lost: Optional[str] = None

    def _fail(self, exc: BaseException) -> LockstepPeerLost:
        """Mark the mirror broken, tear the channel down, and build the
        fatal error every later mirrored call re-raises at once."""
        if self.peer_lost is None:
            self.peer_lost = f"{type(exc).__name__}: {exc}"
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        return LockstepPeerLost(
            f"lockstep follower lost ({self.peer_lost}); the multi-process "
            "mesh cannot make progress — restart the group")

    def __getattr__(self, name):
        core = object.__getattribute__(self, "_core")
        attr = getattr(core, name)
        if name not in MIRRORED:
            return attr

        def mirrored(*args, **kwargs):
            with self._lock:
                if self.peer_lost is not None:
                    raise self._fail(RuntimeError(self.peer_lost))
                # the timer (PhaseTimer) is host-local and unpicklable: the
                # wire copy drops it, the local call keeps it
                wire_kwargs = {k: v for k, v in kwargs.items()
                               if k != "timer"}
                desc = pickle.dumps(
                    (name, _encode(self._table, args),
                     _encode(self._table, wire_kwargs)),
                    protocol=pickle.HIGHEST_PROTOCOL)
                try:
                    for s in self._socks:
                        _send(s, desc)
                except OSError as e:
                    raise self._fail(e) from e
                out = attr(*args, **kwargs)
                self._table.register_outputs(out)
                return out

        return mirrored

    def lockstep_check(self) -> None:
        """Probe the follower channel (the scheduler's error path): a
        collective aborted by a dead peer surfaces as a generic error before
        any channel send fails. Two pings with a gap: the first send after a
        peer death often lands in the TCP buffer, only the second raises."""
        with self._lock:
            if self.peer_lost is not None:
                raise self._fail(RuntimeError(self.peer_lost))
            desc = pickle.dumps((_PING, (), {}))
            try:
                for s in self._socks:
                    _send(s, desc)
                time.sleep(0.05)
                for s in self._socks:
                    _send(s, desc)
            except OSError as e:
                raise self._fail(e) from e

    def close(self) -> None:
        if self.peer_lost is not None:
            return              # channel already torn down by _fail
        try:
            desc = pickle.dumps((_STOP, (), {}))
            for s in self._socks:
                _send(s, desc)
                s.close()
        except OSError:
            pass


def follower_loop(core, sock: socket.socket,
                  watchdog_s: Optional[float] = None) -> int:
    """Replay mirrored calls against this process's EngineCore until the
    coordinator sends stop. Returns the replayed count on a clean stop;
    raises ConnectionError when the channel drops (the caller exits
    nonzero).

    Collective watchdog: if the channel reaches EOF while a replayed call is
    still running, the group lost a peer mid-step and this process may be
    blocked in a collective that can never complete; a monitor thread gives
    the call ``watchdog_s`` (env TTS_LOCKSTEP_WATCHDOG_S, default 120 s)
    after the EOF, then exits the process with rc 17."""
    import sys

    if watchdog_s is None:
        watchdog_s = float(os.environ.get("TTS_LOCKSTEP_WATCHDOG_S", "120"))
    state = {"phase": "recv"}
    done = threading.Event()

    def monitor():
        import select

        while not done.wait(1.0):
            if state["phase"] != "call":
                continue
            # the replay thread is not in recv: peeking is race-free
            try:
                r, _, _ = select.select([sock], [], [], 0)
                if not r:
                    continue
                if sock.recv(1, socket.MSG_PEEK) != b"":
                    continue        # the next call is queued, not EOF
            except OSError:
                pass                # the socket died under us: EOF
            deadline = time.monotonic() + watchdog_s
            while not done.wait(1.0):
                if state["phase"] != "call":
                    return          # the call completed; recv sees the EOF
                if time.monotonic() >= deadline:
                    print("lockstep follower: channel lost with a call in "
                          f"flight; still blocked after {watchdog_s:.0f}s "
                          "(peer-starved collective) — exiting",
                          file=sys.stderr, flush=True)
                    os._exit(17)
            return

    mon = threading.Thread(target=monitor, daemon=True,
                           name="lockstep-watchdog")
    mon.start()
    table = _HandleTable()
    device = getattr(core, "device", "cpu")
    n = 0
    try:
        while True:
            state["phase"] = "recv"
            try:
                raw = _recv(sock)
            except ConnectionError as e:
                raise ConnectionError(
                    f"lockstep channel lost after {n} calls: {e}") from e
            name, args, kwargs = pickle.loads(raw)
            if name == _STOP:
                return n
            if name == _PING:
                continue
            state["phase"] = "call"
            out = getattr(core, name)(*_decode(table, args, device),
                                      **_decode(table, kwargs, device))
            table.register_outputs(out)
            n += 1
    finally:
        done.set()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("handshake: peer closed")
        buf += chunk
    return buf


def coordinator_channel(port: int, n_followers: int,
                        timeout_s: float = 300.0,
                        bind: str = "127.0.0.1") -> List[socket.socket]:
    """Accept the followers' side-channel connections (process 0). Each
    peer must present the shared-token handshake before it takes a
    follower slot; strangers are dropped and accepting goes on, so a port
    scanner cannot wedge the boot. The coordinator acks with its own token
    proof, so followers never unpickle an impostor's bytes."""
    token = _token()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((bind, port))
    srv.listen(n_followers)
    srv.settimeout(timeout_s)
    socks = []
    seen_pids: set = set()
    try:
        while len(socks) < n_followers:
            c, _addr = srv.accept()
            try:
                c.settimeout(10.0)  # a stranger must not stall the boot
                magic, pid, mac = _HELLO.unpack(_recv_exact(c, _HELLO.size))
                if magic != _MAGIC or pid in seen_pids or not \
                        hmac.compare_digest(mac, _hello_mac(token, pid)):
                    raise ConnectionError("bad handshake")
                c.sendall(_ack_mac(token))
            except (ConnectionError, struct.error, OSError):
                c.close()
                continue
            seen_pids.add(pid)
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            c.settimeout(None)      # the channel blocks for the serve
            socks.append(c)
    finally:
        srv.close()
    return socks


def follower_channel(host: str, port: int, timeout_s: float = 300.0,
                     process_id: int = 1) -> socket.socket:
    """Connect a follower to the coordinator's side channel, retrying until
    the coordinator listens; sends the shared-token hello and checks the
    coordinator's ack before returning."""
    token = _token()
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            s = socket.create_connection((host, port), timeout=5.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(15.0)
            s.sendall(_HELLO.pack(_MAGIC, process_id,
                                  _hello_mac(token, process_id)))
            ack = _recv_exact(s, 32)
            if not hmac.compare_digest(ack, _ack_mac(token)):
                s.close()
                # a token mismatch is a configuration error, not a boot race
                raise RuntimeError("coordinator failed token proof — "
                                   "TTS_LOCKSTEP_TOKEN mismatch?")
            # an idle serve sends nothing for minutes: no timeout from here
            s.settimeout(None)
            return s
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.25)
