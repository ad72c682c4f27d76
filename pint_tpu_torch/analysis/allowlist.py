"""graftlint allowlist of the port — every suppression carries its
justification (a port of pint_tpu/analysis/allowlist.py's policy; the
entries are the port's own).

Policy: an entry is a REVIEWED decision that a finding is a false
positive or a sanctioned exception, never a convenience. Each entry
must say WHY the flagged pattern is safe. Stale entries (ones that no
longer suppress anything) fail the lint run, so this list cannot
accumulate dead weight. An inline pragma (``# graftlint: allow G<n> --
reason``) is the other form; an entry here suits a site whose reason
does not fit on its line.

Entry fields:
  rule      the rule id (G1..G17)
  file      repo-relative path the finding is in
  match     substring of the flagged source line (anchors the entry to
            the code, not to a line number that churns)
  why       the written justification
  max_hits  optional, default 1: an entry suppresses at most this many
            violations — a NEW finding sharing the substring surfaces
            for its own review instead of riding an old justification
"""

ALLOWLIST = [
    # ------------------------------------------------------------ G6
    dict(rule="G6", file="chip_smoke.py",
         match="proc = subprocess.Popen(cmd + [\"--journal\"",
         why="serve (h) drives pint_serve's stdin/stdout session, which "
             "subprocess.run cannot: every read is bounded "
             "(queue.get(timeout=600) kills the child and fails the "
             "phase), the SIGTERM wait is wait(timeout=300) and the "
             "reader joins with timeout=60"),
]
