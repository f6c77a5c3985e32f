"""Evaluation: perplexity, activation similarity, quality-drift attribution."""
