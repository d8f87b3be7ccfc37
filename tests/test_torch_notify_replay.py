"""The JAX package's ``tests/test_notify.py`` replayed whole through the
port's ``notify/`` (the cluster API client, its connection pool and retry
policy, the dispatcher with its coalescing and bounded shutdown).

``TestPersistentConnection::test_stale_keepalive_resent_transparently`` has a
race of its own: its one-shot server thread closes the listening socket only
after it has sent the response, so the test's second server can bind the
same port before that close and get ``EADDRINUSE`` (``ROADMAP.md`` §C "Not
port faults"). The replay closes that race with two textual rewrites: the
thread is kept as ``once`` and joined before the second server binds. The
test's assertions are unchanged. Beside it,
``test_stale_keepalive_resent_once_the_listener_is_closed`` states the same
contract in the port's own words.
"""

import socket
import threading
from http.server import ThreadingHTTPServer

from k8s_watcher_tpu_torch.config import RetryPolicy
from k8s_watcher_tpu_torch.notify.client import ClusterApiClient
from test_torch_replay import replay, replayed_tests

_notify = replay("test_notify.py", rewrites=[
    ("k8s_watcher_tpu.config.schema", "k8s_watcher_tpu.config"),
    # the stale keep-alive test: join the one-shot server before the rebind
    ("        threading.Thread(target=serve_once, daemon=True).start()\n",
     "        once = threading.Thread(target=serve_once, daemon=True)\n        once.start()\n"),
    ('        assert client.update_pod_status({"name": "before"}) is True\n',
     '        assert client.update_pod_status({"name": "before"}) is True\n'
     "        once.join(10)\n        assert not once.is_alive()\n"),
])
api_server = _notify.api_server  # the replayed tests' fixture
globals().update(replayed_tests(_notify))


def test_stale_keepalive_resent_once_the_listener_is_closed():
    """One request served on a raw socket whose keep-alive connection the
    server then closes; a real server comes up on the same port only after
    that listener is closed. The second POST must resend on a fresh
    connection without consuming the retry policy (``max_attempts=1``)."""
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def serve_once():
        conn, _ = lsock.accept()
        conn.recv(65536)
        body = b'{"ok":true}'
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        conn.close()
        lsock.close()

    once = threading.Thread(target=serve_once, daemon=True)
    once.start()
    client = ClusterApiClient(f"http://127.0.0.1:{port}", retry=RetryPolicy(max_attempts=1, delay_seconds=0.0))
    assert client.update_pod_status({"name": "before"}) is True
    once.join(10)
    assert not once.is_alive()

    server2 = ThreadingHTTPServer(("127.0.0.1", port), _notify._ApiSink)
    server2.received, server2.script, server2.lock = [], [], threading.Lock()
    server2.daemon_threads = True
    threading.Thread(target=server2.serve_forever, daemon=True).start()
    try:
        assert client.update_pod_status({"name": "after"}) is True
        assert [r["payload"]["name"] for r in server2.received] == ["after"]
    finally:
        server2.shutdown()
        server2.server_close()
