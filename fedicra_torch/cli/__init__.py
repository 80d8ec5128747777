"""The port's command-line entry points: ``train``, ``test`` and ``runner``.

    python -m fedicra_torch.cli.train ...   # federated or --centralized
    python -m fedicra_torch.cli.test ...    # offline CSV and PNG report
    python -m fedicra_torch.cli.runner ...  # the reference launcher's flags
"""
