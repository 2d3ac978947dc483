"""One driver per kind of traffic; a traffic mix's ``kind`` names it."""
