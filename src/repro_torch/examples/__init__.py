"""The port's examples, counterparts of the repo's ``examples/``:

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.long_context_pooling [--device cpu]
  python -m repro_torch.examples.serve_multi_model [--device cpu]
  python -m repro_torch.examples.train_moe [--device cpu]

Each runs on the card unless ``--device cpu`` is given (without a card it
raises), keeps its reference's flags, prints and checks, and ends with
its ``... OK`` line.  Each has ``main(argv=None)``.
"""
