"""Build the rendered documentation site (doc/_build/html).

Sphinx-equivalent static site builder (the image has no Sphinx; it
does have ``markdown``, ``nbconvert``, ``pygments``): renders the
markdown guides (doc/*.md), the generated API reference (doc/api/*.md,
from scripts/gen_api_docs.py), and the executed notebook corpus
(doc/notebooks/*.ipynb, from scripts/build_notebooks.py) into one
browsable site with a shared navigation sidebar -- the analog of the
reference's Sphinx build (/root/reference/doc/source/conf.py,
/root/reference/doc/Makefile).

Run: python scripts/build_docs.py  [or: make -C doc html]
Output: doc/_build/html/index.html
"""
import html
import shutil
import sys
from pathlib import Path

import markdown

REPO = Path(__file__).resolve().parent.parent
DOC = REPO / 'doc'
OUT = DOC / '_build' / 'html'

MD_EXTENSIONS = ['extra', 'toc', 'sane_lists', 'codehilite']
MD_CONFIG = {'codehilite': {'guess_lang': False}}

GUIDES = [
    ('user_guide.md', 'User guide'),
    ('migrating_from_filter_functions.md', 'Migrating from filter_functions'),
    ('qutip_integration.md', 'QuTiP integration'),
]

NOTEBOOK_ORDER = [
    'getting_started',
    'advanced_concatenation',
    'calculating_quantum_processes',
    'extending_pulses',
    'periodic_driving',
    'quantum_fourier_transform',
    'optimal_control',
    'noise_spectroscopy',
    'qutip_integration',
]

PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — filter_functions_tpu</title>
<style>
:root {{ --fg: #1a1a1a; --bg: #ffffff; --accent: #0b5394;
         --sidebar: #f4f6f8; --border: #d9dee3; }}
* {{ box-sizing: border-box; }}
body {{ margin: 0; color: var(--fg); background: var(--bg);
        font: 16px/1.55 -apple-system, 'Segoe UI', Roboto, sans-serif; }}
nav {{ position: fixed; top: 0; left: 0; bottom: 0; width: 272px;
       overflow-y: auto; background: var(--sidebar);
       border-right: 1px solid var(--border); padding: 1.2rem 1rem; }}
nav h1 {{ font-size: 1.05rem; margin: 0 0 .8rem; }}
nav h2 {{ font-size: .78rem; text-transform: uppercase;
          letter-spacing: .06em; color: #5a6672; margin: 1.1rem 0 .3rem; }}
nav a {{ display: block; padding: .14rem 0; color: var(--accent);
         text-decoration: none; font-size: .92rem; }}
nav a.current {{ font-weight: 600; }}
nav a:hover {{ text-decoration: underline; }}
main {{ margin-left: 272px; padding: 2rem 3rem; max-width: 60rem; }}
main h1, main h2, main h3 {{ line-height: 1.25; }}
main h1 {{ border-bottom: 2px solid var(--border); padding-bottom: .3rem; }}
main h2 {{ border-bottom: 1px solid var(--border); padding-bottom: .2rem;
           margin-top: 2rem; }}
pre {{ background: #f6f8fa; border: 1px solid var(--border);
       border-radius: 6px; padding: .8rem 1rem; overflow-x: auto;
       font-size: .86rem; }}
code {{ font-family: ui-monospace, 'SF Mono', Menlo, monospace;
        font-size: .92em; background: #f3f4f6;
        padding: .08em .28em; border-radius: 4px; }}
pre code {{ background: none; padding: 0; }}
table {{ border-collapse: collapse; margin: 1rem 0; font-size: .92rem; }}
th, td {{ border: 1px solid var(--border); padding: .35rem .6rem;
          text-align: left; }}
th {{ background: var(--sidebar); }}
blockquote {{ border-left: 3px solid var(--accent); margin-left: 0;
              padding-left: 1rem; color: #444; }}
{extra_css}
</style>
<script>
MathJax = {{ tex: {{ inlineMath: [['$', '$'], ['\\\\(', '\\\\)']] }},
             options: {{ skipHtmlTags: ['script','noscript','style',
                                        'textarea','pre','code'] }} }};
</script>
<script id="mathjax" async
  src="https://cdn.jsdelivr.net/npm/mathjax@3/es5/tex-mml-chtml.js">
</script>
</head>
<body>
<nav>
<h1><a href="index.html" style="color:inherit">filter_functions_tpu</a></h1>
{nav}
</nav>
<main>
{body}
</main>
</body>
</html>
"""

INDEX_MD = """\
# filter_functions_tpu

A JAX framework for computing generalized filter functions of quantum
control pulses on an accelerator — a from-scratch rebuild of the
capabilities of [qutech/filter_functions](
https://github.com/qutech/filter_functions): split-complex float64
linear algebra, log-depth propagator scans, float64 GEMM contractions,
and frequency/batch sharding over device meshes.

Start with the **[getting started notebook](nb_getting_started.html)**
or the **[user guide](user_guide.html)**; coming from the reference
package, see **[the migration guide](
migrating_from_filter_functions.html)**.

## Highlights

- The full reference API surface: `PulseSequence`, `concatenate` /
  `concatenate_periodic` / `extend` / `remap`, filter functions to
  second order, infidelities, decay amplitudes, frequency shifts,
  cumulant functions, error transfer matrices, and analytic
  gradients — validated element-for-element against the reference.
- Accelerator numerics: the hot control-matrix contraction runs as
  float64 GEMMs on the GPU's tensor cores, with an error-free int8
  digit-slice emulation (`ops.ozaki`) as an alternative mode.
- `jax.grad` through the whole pipeline, plus the reference's
  closed-form gradients as a cross-check.
- Multi-chip scaling over `jax.sharding` meshes with a single
  all-reduce per frequency integral (`parallel`).
"""


def md_render(text: str) -> str:
    return markdown.markdown(text, extensions=MD_EXTENSIONS,
                             extension_configs=MD_CONFIG)


def nav_html(pages, notebooks, api_pages, current: str) -> str:
    def link(href, title):
        cls = ' class="current"' if href == current else ''
        return f'<a href="{href}"{cls}>{html.escape(title)}</a>'

    parts = [link('index.html', 'Overview'), '<h2>Guides</h2>']
    parts += [link(href, title) for href, title in pages]
    parts.append('<h2>Tutorials</h2>')
    parts += [link(href, title) for href, title in notebooks]
    parts.append('<h2>API reference</h2>')
    parts += [link(href, title) for href, title in api_pages]
    return '\n'.join(parts)


def notebook_title(nb) -> str:
    for cell in nb.cells:
        if cell.cell_type == 'markdown' and cell.source.lstrip().startswith('#'):
            return cell.source.lstrip().splitlines()[0].lstrip('# ').strip()
    return 'notebook'


def convert_notebooks():
    """(href, title, body_html, extra_css) per notebook, via nbconvert's
    basic template (body only; our shell supplies chrome)."""
    import nbformat
    from nbconvert import HTMLExporter

    exporter = HTMLExporter(template_name='classic')
    exporter.exclude_input_prompt = False
    out = []
    for name in NOTEBOOK_ORDER:
        path = DOC / 'notebooks' / f'{name}.ipynb'
        if not path.exists():
            continue
        nb = nbformat.read(path, as_version=4)
        body, _ = exporter.from_notebook_node(nb)
        out.append((f'nb_{name}.html', notebook_title(nb), body))
    return out


def main() -> int:
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)

    guide_pages = [(p.replace('.md', '.html'), t) for p, t in GUIDES
                   if (DOC / p).exists()]
    api_files = sorted((DOC / 'api').glob('*.md'))
    api_pages = []
    for f in api_files:
        first = f.read_text().splitlines()[0].lstrip('# ').strip('`')
        title = first.replace('filter_functions_tpu', 'ff_tpu')
        api_pages.append((f.stem + '.html', title))

    notebooks = convert_notebooks()
    nb_index = [(href, title) for href, title, _ in notebooks]

    def emit(href, title, body_html, extra_css=''):
        nav = nav_html(guide_pages, nb_index, api_pages, href)
        (OUT / href).write_text(PAGE.format(
            title=html.escape(title), nav=nav, body=body_html,
            extra_css=extra_css))

    emit('index.html', 'Overview', md_render(INDEX_MD))
    for (href, title), (mdname, _) in zip(guide_pages, GUIDES):
        emit(href, title, md_render((DOC / mdname).read_text()))
    for f, (href, title) in zip(api_files, api_pages):
        emit(href, title, md_render(f.read_text()))
    for href, title, body in notebooks:
        # nbconvert 'classic' emits a full document; extract the body
        # and inline style so it nests inside our shell.
        start = body.find('<body')
        start = body.find('>', start) + 1
        end = body.rfind('</body>')
        styles = ''
        shead = body.find('<style')
        while shead != -1:
            send = body.find('</style>', shead)
            styles += body[body.find('>', shead) + 1:send]
            shead = body.find('<style', send)
        inner = body[start:end]
        (OUT / href).write_text(PAGE.format(
            title=html.escape(title),
            nav=nav_html(guide_pages, nb_index, api_pages, href),
            body=inner,
            extra_css=styles))

    n = len(list(OUT.glob('*.html')))
    print(f'wrote {n} pages to {OUT}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
