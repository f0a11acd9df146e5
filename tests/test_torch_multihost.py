"""The multi-host step-plan channel's units, held against the JAX
package's own functions on the CPU (fast; no process is started).

- On the same secret, nonces and payload bytes, the port's
  ``_session_key`` and the bytes its ``_send_frame`` writes equal the
  reference's (``production_stack_tpu.engine.multihost``), and each
  package's ``_recv_frame`` accepts the other's frame.
- The reference's cases (``tests/test_multihost.py``), as the port's own:
  no secret refuses; a wrong secret is rejected and the right one
  accepted; broadcast frames do not authenticate under the base secret;
  a replayed HELLO without CONFIRM is rejected; the chained ``tokens_dev``
  sentinel is replayed; forbidden types are blocked (a torch tensor's
  rebuild function among them); a replayed or reordered frame is
  rejected; a giant unauthenticated header is capped.
- The port's own: the follower's process id and the leader's settings
  after the handshake; follower-to-leader answers authenticate and a
  replayed one is rejected; a closed channel ends ``follower_loop``
  cleanly; a follower whose socket closed is ``RankLost`` at the
  leader's next call; tensors cross as numpy; ``DistributedConfig``
  reads the environment as the reference's does; a leader handed
  weights refuses a follower with other ones (``weights_fingerprint``).
"""

import os
import pickle
import socket
import threading

import numpy as np
import pytest
import torch

from _torch_multihost import free_port
from production_stack_tpu.engine import multihost as ref
from production_stack_tpu.parallel import distributed as ref_dist
from production_stack_tpu_torch.engine import multihost as mh
from production_stack_tpu_torch.engine.grammar import TokenFsm
from production_stack_tpu_torch.parallel import distributed as pdist


def _leader(secret=b"s", n=1):
    port = free_port()
    bcast = mh.LeaderBroadcaster(port, num_followers=n, secret=secret,
                                 bind_host="127.0.0.1", accept_timeout=10.0,
                                 settings={"math": {}, "threads": 3})

    def wait():
        try:
            bcast.wait_for_followers()
        except OSError:
            pass  # a test closed the leader while it waited

    t = threading.Thread(target=wait, daemon=True)
    t.start()
    return bcast, port, t


def _join(port, secret=b"s", process_id=1, nonce=b"\x01"):
    """A follower's handshake by hand: (socket, session key, the leader's
    settings frame)."""
    conn = socket.create_connection(("127.0.0.1", port), timeout=5)
    f_nonce = nonce * mh._NONCE_BYTES
    mh._send_frame(conn, mh._HELLO + f_nonce, secret)
    conn.settimeout(5)
    l_nonce = mh._recv_frame(conn, secret)
    assert l_nonce is not None and len(l_nonce) == mh._NONCE_BYTES
    key = mh._session_key(secret, f_nonce, l_nonce)
    mh._send_frame(conn, mh._CONFIRM, key)
    mh._send_frame(conn, mh._dumps((1, {"process_id": process_id,
                                        "pid": 7})), key)
    settings = mh._loads(mh._recv_frame(conn, key))
    return conn, key, settings


# -- held against the reference's functions ------------------------------------

def test_constants_are_the_references():
    for name in ("_HELLO", "_NONCE_BYTES", "_CONFIRM", "_MAC_BYTES",
                 "_MAX_HELLO", "_MAX_FRAME", "_CHAINED_NEXT_TOK"):
        assert getattr(mh, name) == getattr(ref, name), name
    assert mh._LEN.format == ref._LEN.format


# fixed values: parameters must collect alike on every test worker
@pytest.mark.parametrize("secret,f_nonce,l_nonce", [
    (b"s", b"\x00" * 16, b"\x01" * 16),
    (b"test-secret", bytes(range(16)), bytes(range(100, 116))),
    (b"\xff" * 64, b"abc" * 5 + b"d", b"\x10" * 16)],
    ids=["zeros", "ramps", "long-secret"])
def test_session_key_is_the_references(secret, f_nonce, l_nonce):
    assert (mh._session_key(secret, f_nonce, l_nonce)
            == ref._session_key(secret, f_nonce, l_nonce))


def _frame_bytes(send, payload, secret):
    a, b = socket.socketpair()
    try:
        send(a, payload, secret)
        a.close()
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        b.close()


@pytest.mark.parametrize("payload", [
    b"", b"x", ref._HELLO + b"\x05" * 16,
    ref._dumps((3, "decode_multi", (np.arange(5, dtype=np.int32),),
                {"fetch": True})),
    bytes(range(256)) * 274],
    ids=["empty", "one", "hello", "step-plan", "70k"])
def test_send_frame_writes_the_references_bytes(payload):
    got = _frame_bytes(mh._send_frame, payload, b"k")
    want = _frame_bytes(ref._send_frame, payload, b"k")
    assert got == want
    assert len(got) == 8 + 32 + len(payload)


@pytest.mark.parametrize("sender,receiver", [(ref, mh), (mh, ref)],
                         ids=["ref-to-port", "port-to-ref"])
def test_each_recv_frame_accepts_the_others_frame(sender, receiver):
    payload = sender._dumps((1, "drop_kv", (), {}))
    a, b = socket.socketpair()
    try:
        sender._send_frame(a, payload, b"secret")
        b.settimeout(5)
        assert receiver._recv_frame(b, b"secret") == payload
        sender._send_frame(a, payload, b"secret")
        with pytest.raises(ConnectionError, match="HMAC"):
            receiver._recv_frame(b, b"other")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("env", [
    {},
    {"PSTPU_COORDINATOR": "10.0.0.5:19700", "PSTPU_NUM_PROCESSES": "4",
     "PSTPU_PROCESS_ID": "3", "PSTPU_CONTROL_PORT": "18200"},
    {"PSTPU_NUM_PROCESSES": "2"}])
def test_distributed_config_reads_the_environment_as_the_reference(
        env, monkeypatch):
    for k in ("PSTPU_COORDINATOR", "PSTPU_NUM_PROCESSES", "PSTPU_PROCESS_ID",
              "PSTPU_CONTROL_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = pdist.DistributedConfig.from_env(), \
        ref_dist.DistributedConfig.from_env()
    for f in ("coordinator", "num_processes", "process_id", "control_port",
              "enabled", "is_leader", "coordinator_host"):
        assert getattr(got, f) == getattr(want, f), f
    # flags win over the environment, as in the reference
    assert pdist.DistributedConfig.from_env(process_id=1).process_id == 1


def test_distributed_config_check():
    with pytest.raises(ValueError, match="--distributed-coordinator"):
        pdist.DistributedConfig(num_processes=2).check()
    with pytest.raises(ValueError, match="host:port"):
        pdist.DistributedConfig("127.0.0.1", 2).check()
    with pytest.raises(ValueError, match="--process-id 2"):
        pdist.DistributedConfig("127.0.0.1:1", 2, 2).check()
    pdist.DistributedConfig().check()  # one process needs nothing


def test_gloo_binds_the_loopback_for_a_local_coordinator():
    assert pdist.local_address("127.0.0.1") == "127.0.0.1"
    assert pdist.local_address("localhost") == "127.0.0.1"
    assert pdist.is_local("localhost")


# -- the reference's cases, as the port's own ----------------------------------

def test_control_plane_refuses_without_secret(monkeypatch):
    monkeypatch.delenv("PSTPU_CONTROL_SECRET", raising=False)
    with pytest.raises(ValueError, match="PSTPU_CONTROL_SECRET"):
        mh.control_secret()
    with pytest.raises(ValueError, match="PSTPU_CONTROL_SECRET"):
        mh.LeaderBroadcaster(free_port(), 1, bind_host="127.0.0.1")
    with pytest.raises(ValueError, match="PSTPU_CONTROL_SECRET"):
        mh.connect_leader("127.0.0.1", free_port(), 1, connect_timeout=0)


def test_leader_rejects_wrong_secret_and_accepts_right_one():
    bcast, port, t = _leader(b"right")
    try:
        bad = socket.create_connection(("127.0.0.1", port), timeout=5)
        mh._send_frame(bad, mh._HELLO + b"\x00" * mh._NONCE_BYTES, b"wrong")
        assert bad.recv(1) == b""  # the leader closed on us
        bad.close()
        good, key, settings = _join(port, b"right")
        assert settings[1] == "_settings"
        assert settings[3] == {"math": {}, "threads": 3}
        t.join(timeout=10)
        assert not t.is_alive() and bcast.pids == [7]
        bcast.broadcast("drop_kv", (), {})
        seq, method, args, kwargs, digest = mh._loads(
            mh._recv_frame(good, key))
        assert (method, args, kwargs) == ("drop_kv", (), {})
        assert seq > settings[0]
        good.close()
    finally:
        bcast.close()


def test_a_follower_with_a_wrong_secret_fails_and_the_leader_waits():
    bcast, port, t = _leader(b"right")
    try:
        with pytest.raises((ConnectionError, OSError)):
            mh.connect_leader("127.0.0.1", port, 1, secret=b"wrong",
                              connect_timeout=5)
        assert t.is_alive() and not bcast.peers
        channel, settings = mh.connect_leader("127.0.0.1", port, 1,
                                              secret=b"right",
                                              connect_timeout=5)
        t.join(timeout=10)
        assert not t.is_alive() and list(bcast.peers) == [1]
        assert settings == {"math": {}, "threads": 3}
        channel.close()
    finally:
        bcast.close()


def test_broadcast_frames_do_not_authenticate_under_base_secret():
    bcast, port, t = _leader(b"s")
    conn, key, _ = _join(port, b"s", nonce=b"\x02")
    try:
        t.join(timeout=10)
        bcast.broadcast("drop_kv", (), {})
        with pytest.raises(ConnectionError, match="HMAC"):
            mh._recv_frame(conn, b"s")  # the base secret must not verify
        other = mh._session_key(b"s", b"\x03" * mh._NONCE_BYTES, key[:16])
        assert other != key
    finally:
        conn.close()
        bcast.close()


def test_leader_rejects_replayed_hello_without_session_confirm():
    bcast, port, t = _leader(b"s")
    try:
        replayer = socket.create_connection(("127.0.0.1", port), timeout=5)
        mh._send_frame(replayer, mh._HELLO + b"\x07" * mh._NONCE_BYTES, b"s")
        replayer.settimeout(5)
        assert mh._recv_frame(replayer, b"s") is not None  # its nonce
        mh._send_frame(replayer, b"garbage-confirm", b"not-the-secret")
        assert replayer.recv(1) == b""
        replayer.close()
        assert t.is_alive() and not bcast.peers
    finally:
        bcast.close()
        t.join(timeout=1)


@pytest.mark.parametrize("process_id", [0, 2, "1"])
def test_leader_refuses_a_follower_without_a_process_id_of_its_group(
        process_id):
    bcast, port, t = _leader(b"s")
    try:
        conn = socket.create_connection(("127.0.0.1", port), timeout=5)
        f_nonce = b"\x04" * mh._NONCE_BYTES
        mh._send_frame(conn, mh._HELLO + f_nonce, b"s")
        conn.settimeout(5)
        key = mh._session_key(b"s", f_nonce, mh._recv_frame(conn, b"s"))
        mh._send_frame(conn, mh._CONFIRM, key)
        mh._send_frame(conn, mh._dumps((1, {"process_id": process_id})),
                       key)
        assert conn.recv(1) == b""
        conn.close()
        assert t.is_alive() and not bcast.peers
    finally:
        bcast.close()
        t.join(timeout=1)


def test_follower_replays_the_chained_tokens_dev_sentinel():
    calls = []

    class Sampled:
        def result(self):
            return (np.array([[4, 5]]),)

    class Runner:
        def decode_multi(self, *a, **kw):
            calls.append(kw["tokens_dev"])
            return (Sampled(), torch.tensor([4, 5]))

    rep = mh.FollowerReplayer(Runner())
    with pytest.raises(RuntimeError, match="cached next_tok"):
        rep.replay("decode_multi", (),
                   {"tokens_dev": mh._CHAINED_NEXT_TOK, "fetch": False})
    rep._next_tok = None
    # a host array passes through untouched (no elementwise ==)
    arr = np.arange(4, dtype=np.int32)
    rep.replay("decode_multi", (), {"tokens_dev": arr, "fetch": True})
    assert calls[-1] is arr
    rep.replay("decode_multi", (), {"tokens_dev": None, "fetch": False})
    cached = rep._next_tok
    rep.replay("decode_multi", (),
               {"tokens_dev": mh._CHAINED_NEXT_TOK, "fetch": False})
    assert calls[-1] is cached


def test_leader_sends_the_sentinel_for_a_device_tokens_dev():
    bcast, port, t = _leader(b"s")
    conn, key, _ = _join(port, b"s")
    try:
        t.join(timeout=10)

        class Inner:
            def decode_multi(self, *a, **kw):
                return "done"

        runner = mh.MirroredRunner(Inner(), None, [], channel=bcast)
        assert runner.decode_multi(np.zeros(2, np.int32),
                                   tokens_dev=torch.tensor([1, 2]),
                                   fetch=False) == "done"
        _, method, args, kwargs, _ = mh._loads(mh._recv_frame(conn, key))
        assert method == "decode_multi"
        assert kwargs["tokens_dev"] == mh._CHAINED_NEXT_TOK
    finally:
        conn.close()
        bcast.close()


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("obj", [
    eval, _Evil(), torch.zeros(3), torch.nn.Parameter(torch.ones(2)),
    np.load, pickle.loads], ids=["eval", "os.system", "tensor", "parameter",
                                  "np.load", "pickle.loads"])
def test_restricted_unpickler_blocks_forbidden_types(obj):
    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        mh._loads(pickle.dumps(obj))


def test_a_tensor_pickle_names_the_rebuild_function_it_is_refused():
    data = pickle.dumps(torch.arange(3))
    assert b"_rebuild_tensor_v2" in data
    with pytest.raises(pickle.UnpicklingError,
                       match="torch._utils._rebuild_tensor_v2"):
        mh._loads(data)


def test_step_plan_shapes_round_trip():
    fsm = TokenFsm(np.array([[1, -1], [1, 1]], np.int32),
                   np.array([False, True]))
    frame = (1, "register_grammar", (3, fsm),
             {"fetch": False, "tokens_dev": mh._CHAINED_NEXT_TOK,
              "shape": (2, 3), "x": np.float32(2.5), "ids": {1, 2},
              "none": None, "b": b"\x00"}, "digest")
    seq, method, args, kwargs, digest = mh._loads(mh._dumps(frame))
    assert method == "register_grammar" and isinstance(args[1], TokenFsm)
    np.testing.assert_array_equal(args[1].trans, fsm.trans)
    assert kwargs["x"] == np.float32(2.5) and kwargs["shape"] == (2, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.int64])
def test_tensors_cross_as_numpy(dtype):
    t = (torch.arange(6).reshape(2, 3) * 1.5).to(dtype)
    args, kwargs = mh._wire((t, (t, 3)), {"ctrl": (t, [t]), "n": 1})
    args, kwargs = mh._loads(mh._dumps((args, kwargs)))
    args, kwargs = mh._unwire(args, kwargs, "cpu")
    for got in (args[0], args[1][0], kwargs["ctrl"][0], kwargs["ctrl"][1][0]):
        assert got.dtype == dtype and torch.equal(got, t)
    assert args[1][1] == 3 and kwargs["n"] == 1


def test_replayed_or_reordered_frame_is_rejected():
    a, b = socket.socketpair()
    try:
        channel = mh.FollowerChannel(b, b"key")
        first = mh._dumps((5, "drop_kv", (), {}, ""))
        mh._send_frame(a, first, b"key")
        assert channel.recv()[0] == 5
        mh._send_frame(a, first, b"key")  # replayed
        with pytest.raises(ConnectionError, match="replayed or reordered"):
            channel.recv()
        mh._send_frame(a, mh._dumps((4, "drop_kv", (), {}, "")), b"key")
        with pytest.raises(ConnectionError, match="seq 4 after 5"):
            channel.recv()
    finally:
        a.close()
        b.close()


def test_frame_size_cap_rejects_unauthenticated_giant_header():
    a, b = socket.socketpair()
    try:
        a.sendall(mh._LEN.pack(1 << 40))
        b.settimeout(5)
        with pytest.raises(ConnectionError, match="cap"):
            mh._recv_frame(b, b"secret")
        a.sendall(mh._LEN.pack(mh._MAX_HELLO + 1))
        with pytest.raises(ConnectionError, match="cap"):
            mh._recv_frame(b, b"secret", max_len=mh._MAX_HELLO)
    finally:
        a.close()
        b.close()


# -- the port's own ------------------------------------------------------------

def test_follower_answers_authenticate_and_a_replayed_one_is_rejected():
    bcast, port, t = _leader(b"s")
    conn, key, _ = _join(port, b"s")
    try:
        t.join(timeout=10)
        answer = mh._dumps((2, {"rank": 1}))
        mh._send_frame(conn, answer, key)
        assert bcast.gather({"rank": 0}) == [{"rank": 0}, {"rank": 1}]
        mh._send_frame(conn, answer, key)  # the same answer again
        with pytest.raises(ConnectionError, match="replayed or reordered"):
            bcast.gather({"rank": 0})
        mh._send_frame(conn, mh._dumps((3, {"rank": 1})), b"s")
        with pytest.raises(ConnectionError, match="HMAC"):
            bcast.gather({"rank": 0})  # not under the session key
    finally:
        conn.close()
        bcast.close()


def test_register_lora_sends_each_follower_its_own_share():
    bcast, port, t = _leader(b"s", n=2)
    c1, k1, _ = _join(port, b"s", 1)
    c2, k2, _ = _join(port, b"s", 2, nonce=b"\x09")
    try:
        t.join(timeout=10)
        shares = [{"wq": (np.full(2, r, np.float32),)} for r in range(3)]
        bcast.send_call((1, "register_lora", (1,), {"root": 9}, ""), shares)
        for conn, key, r in ((c1, k1, 1), (c2, k2, 2)):
            _, method, args, kwargs, _ = mh._loads(mh._recv_frame(conn, key))
            assert method == "register_lora" and kwargs["root"] == 9
            np.testing.assert_array_equal(kwargs["share"]["wq"][0],
                                          np.full(2, r, np.float32))
    finally:
        c1.close()
        c2.close()
        bcast.close()


class _Ranks:
    rank = 1


class _Runner:
    device = torch.device("cpu")
    ranks = _Ranks()

    def __init__(self):
        self.calls = []

    def drop_kv(self):
        self.calls.append("drop_kv")


def test_a_closed_channel_ends_follower_loop_cleanly():
    a, b = socket.socketpair()
    runner = _Runner()
    mh._send_frame(a, mh._dumps((1, "drop_kv", (), {}, "")), b"k")
    a.close()
    mh.follower_loop(runner, _Ranks(), mh.FollowerChannel(b, b"k"))
    assert runner.calls == ["drop_kv"]
    b.close()


def test_follower_loop_answers_reports_over_the_channel():
    a, b = socket.socketpair()
    runner = _Runner()
    channel = mh.FollowerChannel(b, b"k")
    done = threading.Thread(target=mh.follower_loop,
                            args=(runner, _Ranks(), channel), daemon=True)
    done.start()
    try:
        a.settimeout(10)
        mh._send_frame(a, mh._dumps((1, "drop_kv", (), {}, "")), b"k")
        mh._send_frame(a, mh._dumps((2, "_report", (), {}, "")), b"k")
        up, report = mh._loads(mh._recv_frame(a, b"k"))
        assert up == 1 and report["calls"] == 1 and report["rank"] == 1
        mh._send_frame(a, mh._dumps((3, "_shutdown", (), {}, "")), b"k")
        done.join(10)
        assert not done.is_alive()
    finally:
        a.close()
        b.close()


def test_a_follower_whose_socket_closed_is_rank_lost_at_the_next_call():
    bcast, port, t = _leader(b"s")
    conn, key, _ = _join(port, b"s")
    t.join(timeout=10)
    try:
        bcast.check_alive()  # nothing to read: alive

        class Inner:
            def drop_kv(self):
                return None

        runner = mh.MirroredRunner(Inner(), None, [], channel=bcast)
        runner.drop_kv()
        conn.close()
        with pytest.raises(mh.RankLost, match="closed the channel"):
            runner.drop_kv()
        with pytest.raises(mh.RankLost):
            bcast.gather(None)
    finally:
        bcast.close()


def test_follower_settings_carry_the_float32_math_and_threads():
    got = mh.follower_settings()
    assert got["threads"] == torch.get_num_threads()
    assert got["math"] == mh.float32_math()
    # a frame can carry them
    assert mh._loads(mh._dumps(got)) == got


def test_weights_fingerprint_tells_weight_sets_apart():
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = EngineConfig.for_model("tiny-llama").model
    params = init_random(cfg, seed=0)
    fp = mh.weights_fingerprint(params)
    assert mh.weights_fingerprint(None) is None
    assert fp == mh.weights_fingerprint(init_random(cfg, seed=0))
    assert fp != mh.weights_fingerprint(init_random(cfg, seed=1))
    one = {"w": torch.zeros(3, 5)}
    moved = {"w": torch.zeros(3, 5)}
    moved["w"][2, 4] = 1e-7  # one value, one bit pattern
    assert mh.weights_fingerprint(one) != mh.weights_fingerprint(moved)
    assert (mh.weights_fingerprint(one)
            != mh.weights_fingerprint({"w": torch.zeros(3, 5,
                                                        dtype=torch.bfloat16)}))
    assert (mh.weights_fingerprint(one)
            != mh.weights_fingerprint({"w": torch.zeros(5, 3)}))
    # a strided sample of a large tensor, the same bits on every copy
    big = torch.randn(3 * mh.FINGERPRINT_SAMPLES + 1)
    assert (mh.weights_fingerprint({"w": big})
            == mh.weights_fingerprint({"w": big.clone()}))


@pytest.mark.parametrize("follower_params", [None, 1],
                         ids=["none", "other-seed"])
def test_a_leader_given_weights_refuses_a_follower_with_other_ones(
        follower_params):
    """A leader handed a params dict and a follower given none (it would
    seed its own) or another set: the leader raises before it joins the
    group, and the follower is refused, so the two never serve different
    models."""
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.testing import multihost_harness as h

    cfg = h.engine_config("tensor")
    dcfg = pdist.DistributedConfig(f"127.0.0.1:{free_port()}", 2, 0,
                                   free_port())
    theirs = (None if follower_params is None
              else init_random(cfg.model, seed=follower_params))
    refused = []

    def follower():
        try:
            mh.connect_leader("127.0.0.1", dcfg.control_port, 1,
                              secret=b"s", connect_timeout=10,
                              weights=mh.weights_fingerprint(theirs))
        except (ConnectionError, OSError) as e:
            refused.append(e)

    t = threading.Thread(target=follower, daemon=True)
    t.start()
    with pytest.raises(ValueError, match="must load the same weights"):
        mh.lead_ranks(cfg, init_random(cfg.model, seed=0), None, "cpu",
                      dcfg, secret=b"s", tensor=2)
    t.join(timeout=10)
    assert not t.is_alive() and len(refused) == 1
