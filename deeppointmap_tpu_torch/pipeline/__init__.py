"""Entry points: model construction and the single-agent inference CLI."""
