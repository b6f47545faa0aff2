"""Coordinator service: rendezvous, typed KV store, barrier, heartbeat
(port of ``hetu_tpu.rpc.coordinator``, stdlib only).

The re-expression of the reference's ``DeviceController`` gRPC service
(Connect/GetRank, CommitHostName/GetHostName, CommitDeviceInfo/
GetDeviceInfo, Barrier, HeartBeat, Exit and the typed KV store) as JSON
lines over TCP on localhost.  The server is the one central process;
worker liveness is tracked by heartbeat timestamps, which the serving
cluster reads as its replicas' health (``dead_ranks``).

``distributed_init`` is the bootstrap of a mesh: the rendezvous through
the coordinator hands ``torch.distributed`` its address (rank 0 binds a
free port and commits ``host:port``, the counterpart of the JAX
package's ``commit_jax_coordinator``), world size and rank, and then
routes ``parallel.comm.barrier`` through the coordinator.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class _State:
    def __init__(self, world_size: Optional[int]):
        self.lock = threading.Condition()
        self.world_size = world_size
        self.ranks: Dict[str, int] = {}           # worker uid -> rank
        self.hostnames: Dict[int, str] = {}
        self.device_info: Dict[int, Any] = {}
        self.kv: Dict[str, Any] = {}
        self.barriers: Dict[str, set] = {}
        self.barrier_gen: Dict[str, int] = {}
        self.last_heartbeat: Dict[int, float] = {}
        self.exited: set = set()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        st: _State = self.server.state  # type: ignore[attr-defined]
        self._conn_ranks: set = set()
        try:
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line.decode())
                    # chaos seam: an installed fault injector may refuse
                    # any op BEFORE dispatch — a refused op proves
                    # nothing (no heartbeat refresh), exactly like a
                    # connection the real coordinator never accepted
                    inj = getattr(self.server, "fault_injector", None)
                    err = inj(req.get("op"), req) if inj else None
                    resp = {"ok": False, "error": err} if err \
                        else self._dispatch(st, req)
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
        finally:
            # connection died: pull this worker's pending barrier entries so
            # a crashed participant can't satisfy (or wedge) a barrier
            with st.lock:
                for group in st.barriers.values():
                    group.difference_update(self._conn_ranks)
                st.lock.notify_all()

    # -- ops ----------------------------------------------------------------

    def _dispatch(self, st: _State, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req["op"]
        with st.lock:
            # any authenticated request proves liveness: refresh the
            # heartbeat so long blocking calls (barrier) on the shared
            # client socket can't starve the heartbeat thread into a
            # false-dead verdict
            if "rank" in req and req["rank"] is not None:
                r = int(req["rank"])
                self._conn_ranks.add(r)
                if r in st.last_heartbeat:
                    st.last_heartbeat[r] = time.time()
            if op == "connect":          # Connect + GetRank
                uid = req["uid"]
                if uid not in st.ranks:
                    if st.world_size is not None \
                            and len(st.ranks) >= st.world_size:
                        # full world: recycle the rank of an exited worker
                        # (restart with a fresh uid); otherwise refuse a
                        # rank >= world_size that would corrupt barriers
                        recyclable = sorted(st.exited)
                        if not recyclable:
                            raise ValueError(
                                f"world is full ({st.world_size}) and no "
                                f"exited rank to recycle for uid {uid!r}")
                        rank = recyclable[0]
                        for old_uid, old_rank in list(st.ranks.items()):
                            if old_rank == rank:
                                del st.ranks[old_uid]
                        st.ranks[uid] = rank
                    else:
                        st.ranks[uid] = len(st.ranks)
                rank = st.ranks[uid]
                st.exited.discard(rank)   # a reconnect revives the rank
                self._conn_ranks.add(rank)
                st.hostnames[rank] = req.get("hostname", uid)
                st.last_heartbeat[rank] = time.time()
                st.lock.notify_all()
                return {"ok": True, "rank": rank,
                        "world_size": st.world_size}
            if op == "get_hostname":     # GetHostName(rank)
                r = int(req["rank"])
                return {"ok": True, "hostname": st.hostnames.get(r)}
            if op == "commit_device_info":
                st.device_info[int(req["rank"])] = req["info"]
                st.lock.notify_all()
                return {"ok": True}
            if op == "get_device_info":
                return {"ok": True,
                        "info": st.device_info.get(int(req["rank"]))}
            if op == "put":              # typed KV Commit*
                st.kv[req["key"]] = req["value"]
                st.lock.notify_all()
                return {"ok": True}
            if op == "get":              # typed KV Get* (optionally blocking)
                deadline = time.time() + float(req.get("timeout", 0.0))
                while req["key"] not in st.kv and time.time() < deadline:
                    st.lock.wait(timeout=min(0.1, deadline - time.time()))
                return {"ok": True, "value": st.kv.get(req["key"])}
            if op == "remove":
                st.kv.pop(req["key"], None)
                return {"ok": True}
            if op == "barrier":          # Barrier(name) over world_size
                name = req.get("name", "default")
                n = int(req.get("world_size") or st.world_size or 0)
                gen = st.barrier_gen.get(name, 0)
                group = st.barriers.setdefault(name, set())
                group.add(int(req["rank"]))
                if len(group) >= n:
                    st.barrier_gen[name] = gen + 1
                    st.barriers[name] = set()
                    st.lock.notify_all()
                    return {"ok": True}
                deadline = time.time() + float(req.get("timeout", 60.0))
                while st.barrier_gen.get(name, 0) == gen:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        group.discard(int(req["rank"]))
                        return {"ok": False, "error": "barrier timeout"}
                    st.lock.wait(timeout=min(0.1, remaining))
                    # waiting at a barrier is liveness too
                    st.last_heartbeat[int(req["rank"])] = time.time()
                return {"ok": True}
            if op == "heartbeat":        # HeartBeat(rank)
                st.last_heartbeat[int(req["rank"])] = time.time()
                return {"ok": True}
            if op == "alive":            # liveness snapshot (monitor use)
                ttl = float(req.get("ttl", 10.0))
                now = time.time()
                alive = [r for r, t in st.last_heartbeat.items()
                         if now - t <= ttl and r not in st.exited]
                dead = [r for r, t in st.last_heartbeat.items()
                        if now - t > ttl and r not in st.exited]
                return {"ok": True, "alive": sorted(alive),
                        "dead": sorted(dead)}
            if op == "exit":             # Exit(rank)
                st.exited.add(int(req["rank"]))
                st.lock.notify_all()
                return {"ok": True}
            if op == "num_connected":
                return {"ok": True, "n": len(st.ranks),
                        "n_exited": len(st.exited)}
            raise ValueError(f"unknown op {op!r}")


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class CoordinatorServer:
    """The central control-plane process (reference polling server).

    ``with CoordinatorServer(port=0) as srv: addr = srv.address`` — or call
    ``start()``/``stop()`` explicitly.  ``port=0`` picks a free port.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 world_size: Optional[int] = None, ttl: float = 10.0):
        # default liveness TTL for dead_ranks() — serving clusters run
        # much tighter failure-detection windows than training jobs, so
        # the server (and each client, see CoordinatorClient(ttl=))
        # carries its own default instead of one hard-coded 10 s
        self.ttl = float(ttl)
        self.state = _State(world_size)
        self._srv = _TCPServer((host, port), _Handler)
        self._srv.state = self.state  # type: ignore[attr-defined]
        self._srv.fault_injector = None  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        h, p = self._srv.server_address[:2]
        return f"{h}:{p}"

    def start(self) -> "CoordinatorServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- fault injection (chaos harness seam) --------------------------------

    def set_fault_injector(self, injector) -> None:
        """Install ``injector(op, req) -> Optional[str]``: a non-None
        return refuses the request with that error string, before
        dispatch (no liveness refresh).  ``None`` uninstalls."""
        self._srv.fault_injector = injector  # type: ignore[attr-defined]

    def refuse_for(self, seconds: float, ops: Optional[set] = None
                   ) -> None:
        """Refuse every op (or just ``ops``) for the next ``seconds``
        of wall time — the ``coord_refuse`` chaos event.  Clients see
        ``RuntimeError: coordinator error: refused (fault injection)``;
        their heartbeat threads must survive it by backing off and
        retrying (``start_heartbeat_thread``)."""
        until = time.time() + float(seconds)

        def injector(op, req):
            if time.time() >= until:
                self.set_fault_injector(None)   # window over: heal
                return None
            if ops is not None and op not in ops:
                return None
            return "refused (fault injection)"
        self.set_fault_injector(injector)

    # -- monitor-side helpers ------------------------------------------------

    def dead_ranks(self, ttl: Optional[float] = None) -> List[int]:
        ttl = self.ttl if ttl is None else float(ttl)
        now = time.time()
        with self.state.lock:
            return sorted(r for r, t in self.state.last_heartbeat.items()
                          if now - t > ttl and r not in self.state.exited)


class CoordinatorClient:
    """Worker-side client (reference C++ ``rpc_client.cc`` surface)."""

    def __init__(self, address: str, uid: Optional[str] = None,
                 hostname: Optional[str] = None,
                 connect_timeout: float = 30.0, ttl: float = 10.0):
        # per-client liveness TTL: alive() calls without an explicit ttl
        # use this, so a monitor tuned for fast failover (serving
        # router) and one tuned for slow links (multi-host training)
        # can share a coordinator without renegotiating every call
        self.ttl = float(ttl)
        host, port = address.rsplit(":", 1)
        deadline = time.time() + connect_timeout
        while True:
            try:
                self._sock = socket.create_connection((host, int(port)),
                                                      timeout=connect_timeout)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        # the connect timeout must NOT become the read timeout: a blocking
        # barrier/get longer than it would raise mid-readline and desync
        # the request/response stream
        self._sock.settimeout(None)
        self._f = self._sock.makefile("rwb")
        self._lock = threading.Lock()
        self.uid = uid or f"{socket.gethostname()}:{id(self)}"
        self.hostname = hostname or socket.gethostname()
        self.rank: Optional[int] = None
        self.world_size: Optional[int] = None

    def _call(self, **req) -> Dict[str, Any]:
        with self._lock:
            self._f.write((json.dumps(req) + "\n").encode())
            self._f.flush()
            line = self._f.readline()
        if not line:
            raise ConnectionError("coordinator closed connection")
        resp = json.loads(line.decode())
        if not resp.get("ok"):
            raise RuntimeError(f"coordinator error: {resp.get('error')}")
        return resp

    # -- rendezvous ---------------------------------------------------------

    def connect(self) -> int:
        r = self._call(op="connect", uid=self.uid, hostname=self.hostname)
        self.rank = r["rank"]
        self.world_size = r.get("world_size")
        return self.rank

    def get_hostname(self, rank: int) -> Optional[str]:
        return self._call(op="get_hostname", rank=rank)["hostname"]

    def commit_device_info(self, info: Any) -> None:
        self._call(op="commit_device_info", rank=self.rank, info=info)

    def get_device_info(self, rank: int) -> Any:
        return self._call(op="get_device_info", rank=rank)["info"]

    # -- KV (typed Commit*/Get* in the proto; JSON carries all types) -------

    def put(self, key: str, value: Any) -> None:
        self._call(op="put", key=key, value=value)

    def get(self, key: str, timeout: float = 0.0) -> Any:
        return self._call(op="get", key=key, timeout=timeout)["value"]

    def remove(self, key: str) -> None:
        self._call(op="remove", key=key)

    # -- barrier / heartbeat / exit -----------------------------------------

    def barrier(self, name: str = "default",
                world_size: Optional[int] = None,
                timeout: float = 60.0) -> None:
        self._call(op="barrier", name=name, rank=self.rank,
                   world_size=world_size, timeout=timeout)

    def heartbeat(self) -> None:
        self._call(op="heartbeat", rank=self.rank)

    def alive(self, ttl: Optional[float] = None
              ) -> Tuple[List[int], List[int]]:
        r = self._call(op="alive",
                       ttl=self.ttl if ttl is None else float(ttl))
        return r["alive"], r["dead"]

    def exit(self) -> None:
        self._call(op="exit", rank=self.rank)

    def close(self) -> None:
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass

    # -- torch.distributed rendezvous ---------------------------------------

    def commit_torch_coordinator(self, address: str) -> None:
        """Rank 0 publishes the ``host:port`` of ``torch.distributed``'s
        store (the JAX package's ``commit_jax_coordinator``)."""
        self.put("torch/coordinator", address)

    def get_torch_coordinator(self, timeout: float = 60.0) -> str:
        addr = self.get("torch/coordinator", timeout=timeout)
        if addr is None:
            raise TimeoutError("torch.distributed address not published")
        return addr

    def start_heartbeat_thread(self, interval: float = 2.0
                               ) -> threading.Event:
        """Background heartbeat (the reference workers ping inside their
        poll loop).  Returns an Event; set it to stop.

        A refused heartbeat (coordinator fault window, transient server
        error) no longer kills the thread: it backs off with the capped
        exponential :class:`~hetu_tpu_torch.fault.backoff.RetryPolicy` and
        keeps trying, so an outage shorter than the liveness TTL never
        turns into a false-dead verdict.  Only a dead transport (the
        socket itself gone) ends the loop — there is nothing left to
        retry onto."""
        from ..fault.backoff import RetryPolicy
        stop = threading.Event()
        policy = RetryPolicy(base=interval, cap=max(4 * interval, 0.5),
                             jitter=0.25)

        def loop():
            failures = 0
            while True:
                delay = interval if failures == 0 \
                    else policy.delay(failures - 1, key=self.rank or 0)
                if stop.wait(delay):
                    return
                try:
                    self.heartbeat()
                    failures = 0
                except (ConnectionError, OSError, ValueError):
                    return            # transport dead / socket closed
                except Exception:
                    failures += 1     # refused: back off, retry
        threading.Thread(target=loop, daemon=True).start()
        return stop



def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def distributed_init(server_address: str, num_hosts: int, device="cuda",
                     uid: Optional[str] = None,
                     dist_port: Optional[int] = None,
                     timeout: float = 60.0,
                     hostname: Optional[str] = None) -> CoordinatorClient:
    """Bootstrap of a multi-process run (the JAX package's
    ``distributed_init``): connect to the coordinator (the rank is the
    connection order), publish this rank's host name and card count, let
    rank 0 publish a free ``host:port``, and join ``torch.distributed``
    there as one of ``num_hosts`` processes (one rank each).  From every
    rank's record ``parallel.mesh.init_process_group`` picks the backend
    (NCCL when each host has a card a rank) and the card (``cuda:{local
    rank}``).  ``hostname`` names the host (``socket.gethostname()`` by
    default).  ``timeout`` bounds the rendezvous and every collective.
    Then ``parallel.comm.barrier`` goes through the coordinator."""
    import torch

    from ..parallel import comm
    from ..parallel.mesh import init_process_group
    client = CoordinatorClient(server_address, uid=uid, hostname=hostname)
    rank = client.connect()
    client.start_heartbeat_thread()
    cards = torch.cuda.device_count() \
        if torch.device(device).type == "cuda" else 0
    client.commit_device_info([client.hostname, cards])
    if rank == 0:
        host = server_address.rsplit(":", 1)[0]
        if host not in ("127.0.0.1", "localhost"):
            host = socket.gethostname()
        client.commit_torch_coordinator(f"{host}:{dist_port or _free_port()}")
    client.barrier("hosts", world_size=num_hosts, timeout=timeout)
    hosts = [client.get_device_info(r) for r in range(num_hosts)]
    addr = client.get_torch_coordinator(timeout=timeout)
    init_process_group(rank, num_hosts, f"tcp://{addr}", device=device,
                       timeout=timeout, hosts=hosts)
    client.barrier("init", world_size=num_hosts, timeout=timeout)
    if client.world_size is None:
        client.world_size = num_hosts
    comm.set_coordinator(client)
    return client
