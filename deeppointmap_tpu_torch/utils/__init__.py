"""Host-side pose math."""
