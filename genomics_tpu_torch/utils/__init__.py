"""Host-side file IO."""
