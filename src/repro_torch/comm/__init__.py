"""Channels (dense, QSGD) and exact message-size formulas."""
