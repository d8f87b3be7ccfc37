"""HTTP plumbing shared by the port's two clients (the cluster API notifier
and the Kubernetes API client), on the standard library: proxy resolution
from the environment and connection set-up through a proxy."""

from __future__ import annotations

import base64
import http.client
import ipaddress
import logging
import os
import ssl
import urllib.request
from typing import Optional, Tuple
from urllib.parse import unquote, urlsplit

logger = logging.getLogger(__name__)


def proxy_for(scheme: str, host: str, port: Optional[int] = None) -> Optional[Tuple[str, int, Optional[str]]]:
    """``(proxy_host, proxy_port, proxy_basic_auth)`` for requests to this
    origin, or None for a direct connection.

    ``urllib.request.getproxies()`` reads the proxy variables (both cases),
    ``proxy_bypass`` applies ``NO_PROXY`` to the host and to ``host:port``,
    and CIDR entries of ``NO_PROXY`` are matched against IP-literal hosts.
    ``ALL_PROXY`` is the fallback. The proxy is reached over plain HTTP (for
    TLS origins the payload rides an end-to-end CONNECT tunnel); a TLS proxy
    URL is refused with a warning and the connection goes direct.
    Credentials in the proxy URL become a ``Proxy-Authorization: Basic``
    header."""
    try:
        if urllib.request.proxy_bypass(host) or (
            port is not None and urllib.request.proxy_bypass(f"{host}:{port}")
        ):
            return None
    except Exception:  # resolver hiccups in bypass lookups must not kill sends
        pass
    try:
        addr = ipaddress.ip_address(host.strip("[]"))
        no_proxy = os.environ.get("no_proxy") or os.environ.get("NO_PROXY") or ""
        for entry in (e.strip() for e in no_proxy.split(",")):
            if "/" in entry:
                try:
                    if addr in ipaddress.ip_network(entry, strict=False):
                        return None
                except ValueError:
                    continue
    except ValueError:
        pass  # a hostname, not an IP literal: the suffix match above suffices
    proxies = urllib.request.getproxies()
    url = proxies.get(scheme) or proxies.get("all")
    if not url:
        return None
    parts = urlsplit(url if "://" in url else f"http://{url}")
    if not parts.hostname:
        logger.warning("Ignoring malformed %s proxy URL %r", scheme.upper(), url)
        return None
    if parts.scheme == "https":
        logger.warning(
            "TLS proxies are not supported (%s=%r); connecting directly", scheme.upper() + "_PROXY", url,
        )
        return None
    auth = None
    if parts.username:
        raw = f"{unquote(parts.username)}:{unquote(parts.password or '')}"
        auth = "Basic " + base64.b64encode(raw.encode("utf-8")).decode("ascii")
    return parts.hostname, parts.port or 80, auth


def new_connection(
    scheme: str, host: str, port: int, timeout: float,
    proxy: Optional[Tuple[str, int, Optional[str]]], ssl_context: Optional[ssl.SSLContext],
) -> http.client.HTTPConnection:
    """A connection honouring ``proxy``: direct, absolute-URI forward proxy
    (plain http), or CONNECT tunnel (https: TLS stays end-to-end)."""
    if proxy is None:
        if scheme == "https":
            return http.client.HTTPSConnection(host, port, timeout=timeout, context=ssl_context)
        return http.client.HTTPConnection(host, port, timeout=timeout)
    proxy_host, proxy_port, proxy_auth = proxy
    if scheme == "https":
        conn = http.client.HTTPSConnection(proxy_host, proxy_port, timeout=timeout, context=ssl_context)
        conn.set_tunnel(host, port, headers={"Proxy-Authorization": proxy_auth} if proxy_auth else None)
        return conn
    return http.client.HTTPConnection(proxy_host, proxy_port, timeout=timeout)
