"""The offline accuracy studies on the port: the espaloma-proxy benchmark
(`espaloma_proxy`, `espaloma_proxy_xl`), its ablation arms (`ablation`),
the learning curve (`lc`) and the hyperparameter sweep (`hpo`).

Counterparts of the JAX package's drivers under experiments/ (named in
each module's doc). Each runs as

    python -m grappa_tpu_torch.experiments.<name> ... [--device cpu]

and trains on CUDA unless asked otherwise. They read two data files of
the repository (the committed espaloma-proxy splits and the benchmark
recipe's experiments/benchmark/grappa_config.yaml) and write every output
under the directory the caller gives, by default
runs/torch_experiments/<study>/.
"""
