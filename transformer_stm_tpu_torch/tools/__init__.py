"""Host-side tools; nothing here touches the card."""
