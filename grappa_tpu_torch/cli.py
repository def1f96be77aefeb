"""Command-line entry points of the port: `python -m grappa_tpu_torch.cli
<command> ...`.

Counterpart of `grappa_tpu.cli` (the reference console scripts grappa_eval
/ grappa_export / grappa_gmx / grappa_train, reference:
pyproject.toml:22-26): train, resume, resume-all, eval, export, gmx,
release, import-ref and ingest-release. Every command that computes takes
`--device` and runs on CUDA unless it names another (`--device cpu`).
`dataset` needs the dataset-creation tools, which the port does not have
yet (ROADMAP.md §1 item 7): `main` answers it as any unknown command.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _device_arg(p: argparse.ArgumentParser):
    p.add_argument('--device', default=None,
                   help='torch device (default: CUDA; cpu runs the plain '
                        'PyTorch path)')


def cmd_train(argv):
    p = argparse.ArgumentParser(prog='grappa_train',
                                description='Run a training from a config '
                                            'file (JSON or YAML).')
    p.add_argument('-c', '--config', required=True, help='config path')
    p.add_argument('-p', '--project-dir', default='runs')
    p.add_argument('-n', '--name', default=None)
    p.add_argument('--safe', action='store_true',
                   help='retry once from last.ckpt on failure')
    _device_arg(p)
    args = p.parse_args(argv)

    from grappa_tpu_torch.train.config import (default_config,
                                               overwrite_config, read_yaml)
    from grappa_tpu_torch.train.run import do_trainrun, safe_trainrun
    config = default_config()
    overwrite_config(read_yaml(args.config), config)
    run = safe_trainrun if args.safe else do_trainrun
    out = run(config, project_dir=args.project_dir, run_name=args.name,
              device=args.device)
    print(json.dumps({'model_dict_path': out['model_dict_path'],
                      'run_dir': out['run_dir']}))


def cmd_resume(argv):
    p = argparse.ArgumentParser(prog='grappa_resume',
                                description='Resume a run from last.ckpt.')
    p.add_argument('run_dir')
    p.add_argument('--extra-epochs', type=int, default=None)
    _device_arg(p)
    args = p.parse_args(argv)
    from grappa_tpu_torch.train.run import resume_trainrun
    out = resume_trainrun(args.run_dir, extra_epochs=args.extra_epochs,
                          device=args.device)
    print(json.dumps({'run_dir': out['run_dir']}))


def cmd_resume_all(argv):
    """Resume every unfinished run of a project directory, one after the
    other (reference: experiments/benchmark/resume_all.py:1-27, which
    scans wandb and resubmits; here the run directories are the record)."""
    p = argparse.ArgumentParser(
        prog='grappa_resume_all',
        description='Resume all unfinished runs in a project directory.')
    p.add_argument('project_dir')
    p.add_argument('--except', dest='excluded', nargs='*', default=[],
                   help='run names to skip')
    p.add_argument('--dry-run', action='store_true',
                   help='only list what would be resumed')
    _device_arg(p)
    args = p.parse_args(argv)

    from grappa_tpu_torch.train.config import read_yaml
    from grappa_tpu_torch.train.run import resume_trainrun

    project = Path(args.project_dir)
    todo, skipped = [], []
    for run_dir in sorted(d for d in project.iterdir() if d.is_dir()):
        if run_dir.name in args.excluded:
            skipped.append({'run': run_dir.name, 'reason': 'excluded'})
            continue
        meta_path = run_dir / 'last.ckpt' / 'meta.json'
        if not meta_path.exists():
            skipped.append({'run': run_dir.name, 'reason': 'no checkpoint'})
            continue
        meta = json.loads(meta_path.read_text())
        config = read_yaml(run_dir / 'grappa_config.yaml')
        target = int(config['trainer_config'].get('max_epochs', 100))
        # meta['epoch'] is the number of completed epochs
        done_epochs = int(meta.get('epoch', 0))
        if done_epochs >= target and (run_dir / 'model.npz').exists():
            skipped.append({'run': run_dir.name, 'reason': 'finished'})
            continue
        todo.append({'run': run_dir.name, 'epochs_done': done_epochs,
                     'target': target})

    print(json.dumps({'to_resume': todo, 'skipped': skipped}, indent=1))
    if args.dry_run:
        return
    for item in todo:
        print(f"resuming {item['run']} "
              f"({item['epochs_done']}/{item['target']} epochs)")
        resume_trainrun(str(project / item['run']), cache_batches=True,
                        device=args.device)


def cmd_eval(argv):
    p = argparse.ArgumentParser(
        prog='grappa_eval',
        description='Evaluate a model on datasets with bootstrap CIs.')
    p.add_argument('-t', '--tag', required=True,
                   help='model tag or model file (.pth/.npz)')
    p.add_argument('-d', '--datasets', nargs='+', required=True,
                   help='dataset tags or directories')
    p.add_argument('--split', default=None,
                   help="split json; default: the model's stored split")
    p.add_argument('--set', default='test', choices=['train', 'val', 'test',
                                                     'all'])
    p.add_argument('--classical', action='store_true',
                   help='also evaluate stored classical force fields')
    p.add_argument('--n-bootstrap', type=int, default=1000)
    p.add_argument('-o', '--output', default=None, help='results json path')
    p.add_argument('--plots', default=None, metavar='DIR',
                   help='scatter plots (not ported yet: raises)')
    p.add_argument('--no-write', action='store_true',
                   help="don't write results back into the model file")
    _device_arg(p)
    args = p.parse_args(argv)

    from grappa_tpu_torch.data.dataset import load_split
    from grappa_tpu_torch.train.eval_model import eval_model
    from grappa_tpu_torch.train.export import (load_model_dict,
                                               model_from_dict,
                                               save_model_dict)
    from grappa_tpu_torch.train.run import load_datasets
    from grappa_tpu_torch.zoo import model_path_from_tag

    model_path = model_path_from_tag(args.tag)
    model_dict = load_model_dict(model_path)
    model, _ = model_from_dict(model_dict)
    ds = load_datasets(args.datasets)
    ds.remove_uncommon_features()

    if args.set != 'all':
        split = (load_split(args.split) if args.split
                 else model_dict.get('split_names') or {})
        if not split:
            # evaluating the whole dataset and storing it as e.g. 'test'
            # would count training molecules in a test metric
            raise SystemExit(
                f"--set {args.set} needs a split, but the model file "
                f"stores none and no --split was given; pass --split "
                f"<json> or use --set all to evaluate everything")
        tr, vl, te = ds.split(split.get('train', []), split.get('val', []),
                              split.get('test', []))
        ds = {'train': tr, 'val': vl, 'test': te}[args.set]
    results = eval_model(model, ds, n_bootstrap=args.n_bootstrap,
                         classical=args.classical, plot_dir=args.plots,
                         device=args.device)
    text = json.dumps(results, indent=1)
    if args.output:
        Path(args.output).write_text(text)
    if not args.no_write:
        # the results go into the model file, as the reference's grappa_eval
        # writes them into the .pth (reference eval_model.py:231-280)
        stored = dict(model_dict.get('results') or {})
        stored[args.set] = results
        model_dict['results'] = stored
        save_model_dict(model_dict, model_path)
    print(text)


def cmd_export(argv):
    p = argparse.ArgumentParser(
        prog='grappa_export',
        description='Export a trainer checkpoint as a model_dict file.')
    p.add_argument('run_dir', help='training run directory')
    p.add_argument('-o', '--output', default=None,
                   help='output .pth or .npz (default <run_dir>/model.pth)')
    p.add_argument('--checkpoint', default='best.ckpt',
                   choices=['best.ckpt', 'last.ckpt'])
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from grappa_tpu_torch.data.dataset import load_split
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.config import read_yaml
    from grappa_tpu_torch.train.export import build_model_dict, save_model_dict
    from grappa_tpu_torch.train.trainer import _verify_checkpoint

    run_dir = Path(args.run_dir)
    ckpt = run_dir / args.checkpoint
    _verify_checkpoint(ckpt)
    config = read_yaml(run_dir / 'grappa_config.yaml')
    meta = json.loads((ckpt / 'meta.json').read_text())
    # the model as the run built it (its statistics), then the checkpoint's
    # weights and scaler buffers
    stats = None
    stats_path = run_dir / 'param_statistics.json'
    if stats_path.exists():
        raw = json.loads(stats_path.read_text())
        stats = {m: {k: np.asarray(v, np.float32) for k, v in raw[m].items()}
                 for m in ('mean', 'std')}
    model = make_model(config['model_config'], stats)
    model.load_state_dict(torch.load(ckpt / 'params.pt', map_location='cpu',
                                     weights_only=True))
    split = {}
    if (run_dir / 'split.json').exists():
        split = load_split(run_dir / 'split.json')
    model_dict = build_model_dict(model, config, split_names=split,
                                  results=meta.get('results'))
    out = Path(args.output) if args.output else run_dir / 'model.pth'
    save_model_dict(model_dict, out)
    print(json.dumps({'exported': str(out)}))


def cmd_gmx(argv):
    p = argparse.ArgumentParser(
        prog='grappa_gmx',
        description='Parametrize a GROMACS topology file with '
                    'grappa_tpu_torch.')
    p.add_argument('-f', '--topology', required=True, help='input .top')
    p.add_argument('-o', '--output', required=True, help='output .top')
    p.add_argument('-t', '--tag', default='latest', help='model tag/path')
    p.add_argument('-c', '--charge-model', default='amber99',
                   choices=['amber99', 'am1BCC'])
    p.add_argument('--resolve-includes', action='store_true',
                   help='inline molecule .itp includes before parametrizing')
    p.add_argument('-p', '--plot', default=None,
                   help='write a violin plot of the predicted parameters')
    p.add_argument('--focus', type=int, nargs='+', default=None,
                   metavar='NR',
                   help='partial reparametrization: only rewrite tuples '
                        'within the model field of view of these atom nrs '
                        '(the kimmdy radical workflow, file-based)')
    _device_arg(p)
    args = p.parse_args(argv)
    from grappa_tpu_torch.wrappers.gromacs_wrapper import GromacsGrappa
    ff = GromacsGrappa.from_tag(args.tag, device=args.device)
    ff.parametrize(args.topology, args.output,
                   charge_model=args.charge_model,
                   focus_nrs=set(args.focus) if args.focus else None,
                   resolve_includes=args.resolve_includes)
    if args.plot:
        # plot the very predictions the parametrize run wrote (no second
        # forward, no second field-of-view derivation: parametrize keeps
        # them in ff.last_predictions per moleculetype and component)
        from grappa_tpu_torch.plotting import plot_parameters
        from grappa_tpu_torch.wrappers.gromacs_wrapper import (
            filter_parameters)
        all_params = []
        for preds in ff.last_predictions.values():
            for pred, apply_nrs in preds:
                all_params.append(pred if apply_nrs is None
                                  else filter_parameters(pred, apply_nrs))
        plot_parameters(all_params, filename=args.plot,
                        title=f'grappa_tpu parameters: {args.topology}'
                              + (f' (focus {sorted(args.focus)})'
                                 if args.focus else ''))
    print(json.dumps({'written': args.output,
                      **({'plot': args.plot} if args.plot else {})}))


def cmd_release(argv):
    p = argparse.ArgumentParser(
        prog='grappa_release',
        description='Upload an exported model file to a GitHub release '
                    '(requires the gh CLI and network access).')
    p.add_argument('model_file', help='exported .pth/.npz model file')
    p.add_argument('-r', '--release-tag', required=True)
    p.add_argument('--repo', default=None, help='owner/repo (default: cwd)')
    args = p.parse_args(argv)
    import shutil
    import subprocess
    if shutil.which('gh') is None:
        raise RuntimeError("the 'gh' CLI is not installed")
    cmd = ['gh', 'release', 'upload', args.release_tag, args.model_file,
           '--clobber']
    if args.repo:
        cmd += ['--repo', args.repo]
    subprocess.run(cmd, check=True)
    print(json.dumps({'uploaded': args.model_file,
                      'release': args.release_tag}))


def _audit_checkpoint(path):
    """Key-for-key audit of a checkpoint file against the reference key
    contract, then the tolerant import. Returns (report, model, config)."""
    import warnings

    from grappa_tpu_torch.train.export import load_model_dict, model_from_dict
    from grappa_tpu_torch.train.torch_compat import expected_reference_keys
    model_dict = load_model_dict(path)
    model_config = model_dict['config'].get('model_config',
                                            model_dict['config'])
    expected = expected_reference_keys(model_config)
    present = set(model_dict['state_dict'])
    report = {
        'file': str(path),
        'keys_in_file': len(present),
        'keys_expected': len(expected),
        'missing_vs_expected': sorted(expected - present),
        'unexpected_in_file': sorted(present - expected),
    }
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        model, config = model_from_dict(model_dict)
        report['import_warnings'] = [str(w.message) for w in caught]
    return report, model, config


def cmd_import_ref(argv):
    p = argparse.ArgumentParser(
        prog='grappa_import_ref',
        description='Import a published reference grappa .pth checkpoint: '
                    'key-for-key audit against the expected reference '
                    'contract, tolerant load with a loud report, and a '
                    'smoke prediction. Without a network, place the file '
                    'at $GRAPPA_TPU_CACHE/models/<tag>.pth first.')
    p.add_argument('-t', '--tag', default=None,
                   help='model tag (grappa-1.2, ...) resolved via the cache')
    p.add_argument('-f', '--file', default=None, help='path to a .pth file')
    _device_arg(p)
    args = p.parse_args(argv)
    if not args.tag and not args.file:
        p.error('need --tag or --file')

    from grappa_tpu_torch.api import Grappa
    from grappa_tpu_torch.data.synthetic import make_moldata
    from grappa_tpu_torch.zoo import model_path_from_tag
    path = Path(args.file) if args.file else model_path_from_tag(args.tag)
    report, model, config = _audit_checkpoint(path)
    pred = Grappa(model, config, args.device).predict(
        make_moldata(seed=0, n_confs=1).molecule)
    report['smoke_predict'] = {
        'n_bonds': int(len(pred.bonds)),
        'bond_k_mean': float(pred.bond_k.mean()),
        'bond_eq_mean': float(pred.bond_eq.mean()),
    }
    print(json.dumps(report, indent=1))


def cmd_ingest_release(argv):
    """The one-command release parity check (reference: training/
    eval_model.py:20-301 and utils/loading_utils.py:7-86): checkpoint audit
    and import -> dataset-zoo resolution -> the espaloma split's test
    molecules evaluated -> the table against the published grappa-1.2
    numbers. Exits 1 when parity fails.

    Without a network, place the released .pth in $GRAPPA_TPU_CACHE/models/
    and the dataset zips (or extracted directories) in
    $GRAPPA_TPU_CACHE/datasets/, then run this command.
    """
    p = argparse.ArgumentParser(
        prog='grappa_ingest_release',
        description=cmd_ingest_release.__doc__)
    p.add_argument('-t', '--tag', default='grappa-1.2',
                   help='model tag or checkpoint path (default grappa-1.2)')
    p.add_argument('-d', '--datasets', nargs='+', default=None,
                   help='dataset tags/dirs; default: every dataset with '
                        'published grappa-1.2 numbers')
    p.add_argument('--split', default='espaloma_split',
                   help='split json path or zoo tag (default espaloma_split)')
    p.add_argument('-o', '--out', default='ingest_report',
                   help='output prefix: writes <out>.json, <out>.md, '
                        '<out>.tex')
    p.add_argument('--n-bootstrap', type=int, default=1000)
    p.add_argument('--rtol', type=float, default=None,
                   help='published-parity relative tolerance '
                        '(default published.PARITY_RTOL)')
    _device_arg(p)
    args = p.parse_args(argv)

    from grappa_tpu_torch.data.dataset import load_split
    from grappa_tpu_torch.published import (GRAPPA_12_TEST_RMSE, PARITY_RTOL,
                                            parity_verdict)
    from grappa_tpu_torch.train.eval_model import eval_model
    from grappa_tpu_torch.train.report import markdown_table, write_report
    from grappa_tpu_torch.train.run import load_datasets, resolve_splitpath
    from grappa_tpu_torch.zoo import model_path_from_tag

    path = model_path_from_tag(args.tag)
    audit, model, config = _audit_checkpoint(path)
    print(f"# checkpoint {path}: {audit['keys_in_file']} keys, "
          f"{len(audit['missing_vs_expected'])} missing vs expected, "
          f"{len(audit['unexpected_in_file'])} unexpected")

    tags = args.datasets or sorted(GRAPPA_12_TEST_RMSE)
    ds = load_datasets(tags)
    ds.remove_uncommon_features()
    split = load_split(resolve_splitpath(args.split))
    _, _, te = ds.split(split.get('train', []), split.get('val', []),
                        split.get('test', []))
    if len(te) == 0:
        raise SystemExit(
            f'the split {args.split!r} selects no test molecules from '
            f'{tags} — wrong split for these datasets?')
    print(f'# evaluating {len(te)} test molecules from {len(tags)} datasets')

    results = eval_model(model, te, n_bootstrap=args.n_bootstrap,
                         device=args.device)['grappa_tpu']
    verdict = parity_verdict(
        {k: v for k, v in results.items() if k != 'avg'},
        rtol=args.rtol if args.rtol is not None else PARITY_RTOL)
    report = {'checkpoint_audit': audit, 'datasets': tags,
              'split': str(args.split), 'results': results,
              'parity': verdict}
    Path(f'{args.out}.json').write_text(json.dumps(report, indent=1))
    table = {'grappa_tpu (imported)': results,
             'published grappa-1.2': GRAPPA_12_TEST_RMSE}
    write_report(table, args.out, with_ci=True)
    print(markdown_table(table, with_ci=False))
    print(f"# wrote {args.out}.json/.md/.tex; published parity "
          f"(rtol={verdict['rtol']}): "
          f"{'PASS' if verdict['pass'] else 'FAIL'}")
    return 0 if verdict['pass'] else 1


COMMANDS = {
    'train': cmd_train,
    'resume': cmd_resume,
    'resume-all': cmd_resume_all,
    'eval': cmd_eval,
    'export': cmd_export,
    'gmx': cmd_gmx,
    'release': cmd_release,
    'import-ref': cmd_import_ref,
    'ingest-release': cmd_ingest_release,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ('-h', '--help'):
        print("usage: python -m grappa_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [args...]")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; available: {sorted(COMMANDS)}")
        return 2
    return COMMANDS[cmd](argv[1:]) or 0


# console-script entry points
def grappa_train():
    cmd_train(sys.argv[1:])


def grappa_eval():
    cmd_eval(sys.argv[1:])


def grappa_export():
    cmd_export(sys.argv[1:])


def grappa_gmx():
    sys.exit(main(['gmx'] + sys.argv[1:]))


def grappa_release():
    cmd_release(sys.argv[1:])


if __name__ == '__main__':
    sys.exit(main())
