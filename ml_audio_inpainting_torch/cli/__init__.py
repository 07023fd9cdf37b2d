"""Command-line entry points of the port: ``inpaint``, ``evaluate``,
``preprocess``, ``build_gaps_table``, ``ar_benchmark``, ``ar_tune``,
``ar_plots``, ``train``, ``train_refiner`` and ``soup``."""
