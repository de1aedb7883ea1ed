"""The harness shared by every cell: context, window, trace, scenes, bounds."""
