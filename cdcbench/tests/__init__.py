"""The benchmark's CPU tests (they need no card; the few that do are marked cuda)."""
