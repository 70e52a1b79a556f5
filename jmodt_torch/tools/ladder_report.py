"""Render a synthetic-ladder run's log as a markdown report.

    python -m jmodt_torch.tools.ladder_report --log LOG [LOG ...]
        [--out LADDER_RESULTS.md] [--title TEXT]

The counterpart of `tools/ladder_report.py`, pure host.  It parses the
ladder's log (`python -m jmodt_torch.tools.synthetic_ladder`, whose
training stages print `python -m jmodt_torch.train`'s
`finetune=... fusion=... epochs=...` header and its per-epoch
`epoch N: train_loss=...` lines, numbered from 1 in each stage) and the
final JSON line, and writes each stage's loss curve (downsampled), the
final AP and the CLEAR-MOT numbers scraped from the evaluation lines.

A run that was relaunched appends segments to its log: each resume prints
the stage header again and numbers epochs from the restored one.  Segments
with the same header are one stage (on a repeated epoch the later line
wins), and `--log` takes several files, read in order.
"""

from __future__ import annotations

import argparse
import json
import re


def _iter_lines(log_paths):
    for p in log_paths:
        with open(p, errors='replace') as f:
            yield from f


def parse(log_paths):
    stages = []          # list of {'finetune', 'epochs', 'hist'}
    cur = None
    final_json = None
    eval_lines = []
    for line in _iter_lines(log_paths):
        m = re.search(r'finetune=(\S+)(?: fusion=(\S+))? epochs=(\d+)',
                      line)
        if m:
            # fusion= splits stage 1 from stage 2 even when epochs1 ==
            # epochs2; None on logs whose header has no fusion=
            cur = {'finetune': m.group(1) == 'True',
                   'fusion': (None if m.group(2) is None
                              else m.group(2) == 'True'),
                   'epochs': int(m.group(3)), 'hist': []}
            stages.append(cur)
            continue
        m = re.search(r'epoch (\d+): train_loss=([\d.naif-]+) '
                      r'\(([\d.]+)s', line)
        if m and cur is not None:
            # exact 0.0 is the trainer's "no loss sampled yet" placeholder
            # ONLY on the first line(s) after a process launch (epochs
            # shorter than log_every carry last_logged, which starts at
            # 0.0) — every relaunch re-prints the stage header, so the
            # placeholder condition is "no real loss seen this segment".
            # A later 0.0 is a genuinely converged epoch (single-batch
            # overfit runs do reach ~0) and must be kept.
            v = float(m.group(2))
            if v > 0.0 or cur['hist']:
                cur['hist'].append((int(m.group(1)), v,
                                    float(m.group(3))))
            continue
        if re.search(r'(AP[@:]|Car AP|recall|MOTA|MOTP|eval|mostly|'
                     r'fragment|id switch)', line, re.I):
            eval_lines.append(line.rstrip('\n'))
        s = line.strip()
        if s.startswith('{') and '"mota"' in s:
            try:
                final_json = json.loads(s)
            except ValueError:
                pass
    return _merge_resumes(stages), eval_lines, final_json


def _merge_resumes(stages):
    """Fold supervisor-relaunch segments into their original stage: every
    segment with the same (finetune, fusion, epochs) header is the same
    ladder stage (the supervisor relaunches with identical stage
    parameters) — including weights-only restarts that begin again at
    epoch 1 and crash segments that logged nothing.  On duplicate epoch
    numbers the later segment's line wins (the last run through that
    epoch is the one whose weights survive)."""
    merged = []
    for st in stages:
        prev = next((m for m in reversed(merged)
                     if (m['finetune'], m['fusion'], m['epochs'])
                     == (st['finetune'], st['fusion'], st['epochs'])),
                    None)
        if prev is not None:
            by_epoch = {e: (e, v, s) for e, v, s in prev['hist']}
            by_epoch.update({e: (e, v, s) for e, v, s in st['hist']})
            prev['hist'] = [by_epoch[e] for e in sorted(by_epoch)]
        else:
            merged.append(st)
    return merged


def _ap05_block(eval_lines):
    """Pull the `bev AP` / `3d AP` rows that follow the
    `Car AP@0.70, 0.50, 0.50:` header out of the eval extract."""
    rows, active = [], False
    for line in eval_lines:
        if 'AP@0.70, 0.50' in line:
            active = True
            continue
        m = re.match(r'\s*(bev|3d)\s+AP:\s*(.*)', line)
        if active and m:
            rows.append((f'AP_{m.group(1)}', m.group(2).strip()))
        elif active and rows:
            break
    return rows


def curve(hist, points=12):
    if not hist:
        return '(no epochs logged)'
    step = max(1, len(hist) // points)
    rows = hist[::step]
    if rows[-1] != hist[-1]:
        rows.append(hist[-1])
    return ' '.join(f'{e}:{v:.2f}' for e, v, _ in rows)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--log', required=True, nargs='+',
                    help='one or more log files, concatenated in order')
    ap.add_argument('--out', default='LADDER_RESULTS.md')
    ap.add_argument('--title', default='')
    args = ap.parse_args(argv)

    stages, eval_lines, final = parse(args.log)
    names = ['stage 1 (lidar-only detector, from scratch)',
             'stage 2 (LI-fusion, partial-restore bootstrap)',
             'stage 3 (link/se finetune, trunk frozen)']
    out = [f'# Synthetic-ladder results {args.title}'.rstrip(), '']
    out += ['Full 3-stage train -> eval -> track ladder on the synthetic '
            'KITTI-format tree (no real dataset in this image; reference '
            'pipeline tools/train.py:50-144 -> tools/eval.py).  Loss '
            'curves are `epoch:train_loss` samples.', '']
    for i, st in enumerate(stages):
        nm = names[i] if i < len(names) else f'stage {i + 1}'
        out.append(f'## {nm} — {st["epochs"]} epochs')
        out.append('')
        hist = st['hist']
        out.append(f'- curve: `{curve(hist)}`')
        if hist:
            t = sum(s for _, _, s in hist)
            out.append(f'- final train_loss **{hist[-1][1]:.3f}** '
                       f'({len(hist)} epochs logged, {t / 60:.1f} min)')
        out.append('')
    if final:
        out.append('## Final evaluation (synthetic val split)')
        out.append('')
        out.append(f'- AP_3d moderate @0.7 IoU (R40): '
                   f'**{final["ap_3d_moderate"]:.2f}**')
        out.append(f'- AP_bev moderate @0.7 IoU (R40): '
                   f'**{final["ap_bev_moderate"]:.2f}**')
        # the official 0.5-IoU sweep (printed right after the 0.7 block)
        # is the more informative number for a lightly-trained detector
        ap05 = _ap05_block(eval_lines)
        for nm, vals in ap05:
            out.append(f'- {nm} @0.5 IoU (easy/mod/hard): **{vals}**')
        # null when the evaluation scored no sequence
        mota = final['mota']
        out.append('- MOTA: **n/a**' if mota is None
                   else f'- MOTA: **{mota:.4f}**')
        out.append('')
    if eval_lines:
        out.append('## Eval log extract')
        out.append('')
        out.append('```')
        out += eval_lines[-60:]
        out.append('```')
    with open(args.out, 'w') as f:
        f.write('\n'.join(out) + '\n')
    print(f'wrote {args.out} ({len(stages)} stages, '
          f'final_json={"yes" if final else "MISSING"})')
    return args.out


if __name__ == '__main__':
    main()
