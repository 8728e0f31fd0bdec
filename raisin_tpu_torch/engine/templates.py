"""HTML benchmark page (functional parity with templates/benchmark.html).

The port's copy of raisin_tpu/engine/templates.py: the same page, byte for byte.

The reference serves a Jekyll-styled page whose body carries the rendered
benchmark tables and a unix timestamp that client-side JS turns into a
"Ran X ago" caption (templates/benchmark.html:54-88). This is our own
equivalent page, not a copy.
"""

from __future__ import annotations

import time

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>raisin-tpu benchmarks</title>
<style>
  body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 72rem; }}
  h1 {{ font-weight: 600; }}
  .go-pretty-table {{ border-collapse: collapse; margin: 1rem 0; }}
  .go-pretty-table th, .go-pretty-table td {{
    border: 1px solid #999; padding: 0.3rem 0.7rem; text-align: left;
  }}
  .go-pretty-table th {{ background: #f0f0f0; }}
  #ran-ago {{ color: #666; }}
</style>
</head>
<body>
<h1>Benchmarks</h1>
<p id="ran-ago" data-created="{created}"></p>
{tables}
<script>
  (function () {{
    var created = Number(document.getElementById("ran-ago").dataset.created);
    var delta = Math.max(0, Math.floor(Date.now() / 1000) - created);
    var units = [["day", 86400], ["hour", 3600], ["minute", 60], ["second", 1]];
    for (var i = 0; i < units.length; i++) {{
      var n = Math.floor(delta / units[i][1]);
      if (n >= 1 || units[i][0] === "second") {{
        document.getElementById("ran-ago").textContent =
          "Ran " + n + " " + units[i][0] + (n === 1 ? "" : "s") + " ago";
        break;
      }}
    }}
  }})();
</script>
</body>
</html>
"""


def render_benchmark_page(tables_html: str, created: int | None = None) -> str:
    created = int(time.time()) if created is None else created
    return _PAGE.format(tables=tables_html, created=created)
