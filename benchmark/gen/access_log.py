"""Apache access logs in the Combined Log Format, from a session model.

One line a request, `%h %l %u %t "%r" %>s %b "%{Referer}i"
"%{User-agent}i"`, as Apache's `combined` LogFormat writes it:

    203.0.113.7 - - [10/Oct/2024:13:55:36 +0000] "GET /docs/cache-9.html
    HTTP/1.1" 200 48213 "https://www.google.com/" "Mozilla/5.0 (...)"

The documents are one site's rotated logs. The site, drawn once from
`site_seed`, has `pages` HTML pages and `objects` embedded files (images,
style sheets, scripts). Each file has one size; each page embeds a fixed
list of objects; each client address keeps one user agent, one protocol
and one user name. The traffic follows SURGE's model of a user (Barford
and Crovella, "Generating Representative Web Workloads for Network and
Server Performance Evaluation", SIGMETRICS 1998, table of distributions):

  * file sizes: log-normal body (mu 9.357, sigma 1.318), and above
    133,000 B a Pareto tail (k 133,000, alpha 1.1);
  * popularity of pages and of objects: Zipf, exponent 1;
  * embedded references a page: Pareto (k 1, alpha 2.43), rounded down;
  * active OFF time between a page's requests: Weibull (shape 1.46,
    scale 0.382 s);
  * inactive OFF time between two pages of a session: Pareto (k 1 s,
    alpha 1.5).

and Arlitt and Williamson's invariants of web server logs ("Internet Web
Servers: Workload Characterization and Performance Implications",
IEEE/ACM Trans. Networking 5(5), 1997): about 88% of requests succeed
(200); sessions arrive as a Poisson process (inter-reference times
exponential and independent); 10% of the clients make 75% or more of
the requests, which the Zipf exponent of the client addresses is chosen
to give within a document. A session's pages refer to the page before;
a page's objects refer to the page. The parameters the sources leave
open (the site's size, pages a session, the session rate, the split of
the unsuccessful 12%, external referers, methods) are the traffic
file's, named there as assumed.

Every session is drawn whole, with NumPy in batches; the sessions'
requests are sorted by time and the lines joined once. A document is
exactly `doc_bytes`: the lines up to that size, of sessions that all
started before the cut, so no session near the end is missing. Document
i of a pool made from the run's seed s has the seed s * pool + i.
"""

import time

import numpy as np

_MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
           "Oct", "Nov", "Dec")
_SECTIONS = (b"docs", b"blog", b"products", b"news", b"support", b"about",
             b"help", b"downloads", b"category", b"guide")
_WORDS = (b"index", b"install", b"release", b"notes", b"pricing", b"faq",
          b"overview", b"setup", b"account", b"contact", b"search",
          b"reference", b"tutorial", b"archive", b"team", b"features",
          b"security", b"status", b"terms", b"privacy", b"changelog",
          b"api", b"guide", b"cache", b"compare", b"download", b"events")
_OBJECTS = ((b"static/img", (b".png", b".jpg", b".gif", b".svg")),
            (b"static/css", (b".css",)),
            (b"static/js", (b".js",)),
            (b"static/fonts", (b".woff2",)))
_OBJECT_KIND = (0.70, 0.10, 0.17, 0.03)
_BROWSERS = (
    b"Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
    b"(KHTML, like Gecko) Chrome/{v}.0.0.0 Safari/537.36",
    b"Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15_7) AppleWebKit/605.1.15 "
    b"(KHTML, like Gecko) Version/{v}.1 Safari/605.1.15",
    b"Mozilla/5.0 (X11; Linux x86_64; rv:{v}.0) Gecko/20100101 Firefox/{v}.0",
    b"Mozilla/5.0 (iPhone; CPU iPhone OS 17_{v} like Mac OS X) "
    b"AppleWebKit/605.1.15 (KHTML, like Gecko) Version/17.{v} Mobile/15E148 "
    b"Safari/604.1",
    b"Mozilla/5.0 (Linux; Android 14; Pixel {v}) AppleWebKit/537.36 "
    b"(KHTML, like Gecko) Chrome/120.0.0.0 Mobile Safari/537.36",
    b"Mozilla/5.0 (compatible; Googlebot/2.{v}; "
    b"+http://www.google.com/bot.html)",
    b"curl/8.{v}.0",
)
_PROTOCOLS = (b"HTTP/1.1", b"HTTP/2.0", b"HTTP/1.0")
_EXTERNAL = (b"https://www.google.com/", b"https://www.bing.com/",
             b"https://duckduckgo.com/", b"https://t.co/",
             b"https://news.ycombinator.com/", b"https://github.com/",
             b"https://www.reddit.com/", b"https://www.facebook.com/")
_METHODS = (b"GET", b"POST", b"HEAD")


def _zipf(rng, n, k, s):
    """k indices into 0..n-1, Zipf-weighted with exponent s (index 0
    the most popular)."""
    w = 1.0 / np.arange(1, n + 1) ** s
    return rng.choice(n, size=k, p=w / w.sum())


def _shares(rng, shares, k):
    """k indices drawn with the given shares."""
    p = np.asarray(shares, float)
    return rng.choice(len(p), size=k, p=p / p.sum())


def _sizes(rng, n, mu, sigma, tail_k, tail_alpha):
    """n file sizes: log-normal, with every draw above tail_k drawn
    again from the Pareto tail."""
    s = rng.lognormal(mu, sigma, n)
    tail = s > tail_k
    s[tail] = tail_k * (1.0 - rng.random(int(tail.sum()))) ** (
        -1.0 / tail_alpha)
    return np.minimum(s, 1 << 40).astype(np.int64)


class _Site:
    """The site's files, pages, embedded lists and clients, drawn once
    from `site_seed`; index 0 of each pool is its most popular."""

    def __init__(self, p):
        rng = np.random.default_rng(p["site_seed"])
        n, m, a = p["pages"], p["objects"], p["addresses"]
        sec = rng.integers(0, len(_SECTIONS), n)
        wd = rng.integers(0, len(_WORDS), n)
        num = rng.integers(1, 1000, n)
        self.page = [b"/%s/%s-%d.html" % (_SECTIONS[x], _WORDS[y], z)
                     for x, y, z in zip(sec.tolist(), wd.tolist(),
                                        num.tolist())]
        self.page[0] = b"/"
        kind = _shares(rng, _OBJECT_KIND, m)
        ext = rng.integers(0, 4, m)
        wd = rng.integers(0, len(_WORDS), m)
        h = rng.integers(0, 1 << 32, m)
        self.obj = [b"/%s/%s.%08x%s" % (
            _OBJECTS[k][0], _WORDS[w], x, _OBJECTS[k][1][e % len(
                _OBJECTS[k][1])])
            for k, e, w, x in zip(kind.tolist(), ext.tolist(), wd.tolist(),
                                  h.tolist())]
        size = (p["size_mu"], p["size_sigma"], p["tail_k"], p["tail_alpha"])
        self.page_size = _sizes(rng, n, *size)
        self.obj_size = _sizes(rng, m, *size)
        # the objects each page embeds: Pareto(1, 2.43) of them, rounded
        # down, drawn by the objects' popularity
        ne = np.floor((1.0 - rng.random(n)) ** (-1.0 / p["embedded_alpha"])
                      * p["embedded_k"]).astype(np.int64)
        self.embed_start = np.concatenate([[0], np.cumsum(ne)])
        self.embed = _zipf(rng, m, int(ne.sum()), p["file_zipf"])
        # each client address keeps its agent, protocol and user name
        self.ip = [b"%d.%d.%d.%d" % tuple(x) for x in np.column_stack(
            [rng.integers(1, 224, a),
             rng.integers(0, 256, (a, 3))]).tolist()]
        agents = [_BROWSERS[i].replace(b"{v}", b"%d" % v) for i, v in zip(
            rng.integers(0, len(_BROWSERS), p["agents"]).tolist(),
            rng.integers(1, 130, p["agents"]).tolist())]
        ag = _zipf(rng, p["agents"], a, 1.0)
        self.agent = [agents[i] for i in ag.tolist()]
        self.proto = [_PROTOCOLS[i] for i in _shares(
            rng, p["protocol_shares"], a).tolist()]
        named = rng.random(a) < p["user_share"]
        ids = rng.integers(0, 100000, a)
        self.user = [b"user%d" % u if s else b"-"
                     for s, u in zip(named.tolist(), ids.tolist())]
        self.host = b"https://" + p["host"].encode()
        self.error_size = {404: int(rng.integers(180, 240)),
                           302: int(rng.integers(180, 240)),
                           500: int(rng.integers(500, 600))}


def _sessions(site, p, rng, t0, count):
    """`count` whole sessions starting after t0; returns their requests
    as arrays (time, address, page or -1, object or -1, referer page or
    -1, external referer index or -1, status, method) and the last
    session's start."""
    starts = t0 + np.cumsum(rng.exponential(1.0 / p["session_rate"], count))
    client = _zipf(rng, p["addresses"], count, p["client_zipf"])
    npages = rng.geometric(1.0 / p["pages_per_session"], count)
    tot = int(npages.sum())
    sess = np.repeat(np.arange(count), npages)
    first = np.concatenate([[0], np.cumsum(npages)[:-1]])
    pg = _zipf(rng, p["pages"], tot, p["file_zipf"])
    # page times: the session's start, then for each page its objects'
    # active OFF times and one inactive OFF time before the next page
    ne = site.embed_start[pg + 1] - site.embed_start[pg]
    off_in = (1.0 - rng.random(tot)) ** (-1.0 / p["inactive_alpha"]) * \
        p["inactive_k"]
    act = rng.weibull(p["active_shape"], int(ne.sum())) * p["active_scale"]
    obj_page = np.repeat(np.arange(tot), ne)
    obj_first = np.concatenate([[0], np.cumsum(ne)[:-1]])
    act_cum = np.cumsum(act)
    act_base = np.concatenate([[0.0], act_cum])[obj_first]
    obj_off = act_cum - np.repeat(act_base, ne)          # within the page
    busy = np.zeros(tot)
    np.add.at(busy, obj_page, act)
    step = busy + off_in                                  # page to next page
    cum = np.cumsum(step)
    before = cum - step - (cum - step)[first][sess]       # since session start
    page_t = starts[sess] + before
    obj_t = page_t[obj_page] + obj_off
    # referers: a page refers to the page before it in its session; the
    # first page to an external site or to none
    prev = np.concatenate([[-1], pg[:-1]])
    is_first = np.zeros(tot, bool)
    is_first[first] = True
    prev[is_first] = -1
    ext = np.where(is_first, _shares(rng, p["external_shares"], tot) - 1, -1)
    n_obj = len(obj_page)
    time_ = np.concatenate([page_t, obj_t])
    addr = np.concatenate([client[sess], client[sess][obj_page]])
    page = np.concatenate([pg, np.full(n_obj, -1)])
    obj = np.concatenate([np.full(tot, -1), site.embed[
        site.embed_start[pg][obj_page] + (np.arange(n_obj) - obj_first[
            obj_page])]])
    ref = np.concatenate([prev, pg[obj_page]])
    ref_ext = np.concatenate([ext, np.full(n_obj, -1)])
    k = len(time_)
    status = np.array((200, 304, 302, 404, 500))[_shares(
        rng, p["status_shares"], k)]
    # objects are fetched; a page may be posted to or only asked about
    method = np.where(page >= 0, _shares(rng, p["method_shares"], k), 0)
    return (time_, addr, page, obj, ref, ref_ext, status, method), \
        float(starts[-1])


def _lines(site, req):
    """The requests' log lines, in the order given."""
    time_, addr, page, obj, ref, ref_ext, status, method = req
    secs = time_.astype(np.int64)
    stamps = {}
    for s in np.unique(secs).tolist():
        g = time.gmtime(s)
        stamps[s] = b"[%02d/%s/%04d:%02d:%02d:%02d +0000]" % (
            g.tm_mday, _MONTHS[g.tm_mon - 1].encode(), g.tm_year,
            g.tm_hour, g.tm_min, g.tm_sec)
    out = []
    for a, s, pg, ob, rf, rx, st, m in zip(
            addr.tolist(), secs.tolist(), page.tolist(), obj.tolist(),
            ref.tolist(), ref_ext.tolist(), status.tolist(), method.tolist()):
        if pg >= 0:
            path, size = site.page[pg], site.page_size[pg]
        else:
            path, size = site.obj[ob], site.obj_size[ob]
        if st == 304 or _METHODS[m] == b"HEAD":
            nb = b"-"
        elif st == 200:
            nb = b"%d" % size
        else:
            nb = b"%d" % site.error_size[st]
        if rf >= 0:
            referer = site.host + site.page[rf]
        elif rx >= 0:
            referer = _EXTERNAL[rx]
        else:
            referer = b"-"
        out.append(b'%s - %s %s "%s %s %s" %d %s "%s" "%s"\n' % (
            site.ip[a], site.user[a], stamps[s], _METHODS[m], path,
            site.proto[a], st, nb, referer, site.agent[a]))
    return out


def document(size: int, seed: int, **params) -> bytes:
    """`size` bytes of the site's log lines, drawn from `seed`;
    `params` are the traffic file's."""
    site = _Site(params)
    rng = np.random.default_rng(seed)
    parts, last = [], 1.6e9 + float(rng.integers(0, 1 << 27))
    # a session is about pages_per_session * 2.3 requests of ~250 B
    batch = max(64, int(size / (250 * 2.3 * params["pages_per_session"])))
    while True:
        req, last = _sessions(site, params, rng, last, batch)
        parts.append(req)
        req = tuple(np.concatenate(c) for c in zip(*parts))
        order = np.argsort(req[0], kind="stable")
        due = order[req[0][order] <= last]
        lines = _lines(site, tuple(c[due] for c in req))
        out = b"".join(lines)
        if len(out) >= size:
            return out[:size]
        batch = max(64, batch // 4)


def documents(seed: int, doc_bytes: int, pool: int, **params) -> list:
    """The pool of `pool` documents of `doc_bytes` each for a run's
    seed; `params` are the site's and the sessions' (the traffic
    file's)."""
    return [document(doc_bytes, (seed * pool + i) % (1 << 128), **params)
            for i in range(pool)]
