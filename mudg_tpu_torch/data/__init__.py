"""Host-side data loading (item lists, condition windows)."""
